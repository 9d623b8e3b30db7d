"""Each generator is deterministic from the seed, keeps to its file's
ranges and rate, and gives every seed the same work in its own order."""

import collections

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.traffic import batches, open_loop

SERVE = spec.load_cell("starcoder2-3b.complete")["traffic"]
TRAIN = spec.load_cell("gpt2-xl.train")["traffic"]
BIG = 2**33 + 12345      # seeds beyond 32 bits


def _key(reqs):
    return [(r["due_s"], r["prompt"].tobytes(), r["output_len"]) for r in reqs]


def test_open_loop_deterministic_from_seed():
    a = open_loop.schedule(SERVE, BIG, 20, 49152)
    b = open_loop.schedule(SERVE, BIG, 20, 49152)
    c = open_loop.schedule(SERVE, BIG + 1, 20, 49152)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("seconds", [10, 40, 51])
def test_open_loop_ranges_and_rate(seconds):
    reqs = open_loop.schedule(SERVE, BIG, seconds, 49152)
    rate = SERVE["rate_per_s"]
    # rate x seconds requests, less any whose stratified gaps sum past the
    # window's end
    assert round(rate * seconds) - 1 <= len(reqs) <= round(rate * seconds)
    due = [r["due_s"] for r in reqs]
    assert due == sorted(due) and 0 < due[0] and due[-1] < seconds
    assert abs(due[-1] - seconds) < 0.1 * seconds
    p, o = SERVE["prompt_len"], SERVE["output_len"]
    for r in reqs:
        assert p["min"] <= len(r["prompt"]) <= p["max"]
        assert o["min"] <= r["output_len"] <= o["max"]
        assert r["prompt"].dtype == np.int32 and r["prompt"].max() < 49152
    # log-uniform: a third of the prompts in each octave of 512-4096
    octaves = collections.Counter(
        min(2, int(np.log2(len(r["prompt"]) / 512))) for r in reqs)
    for k in range(3):
        assert abs(octaves[k] / len(reqs) - 1 / 3) < 0.05


def test_open_loop_same_work_every_seed():
    def work(seed):
        return [(r["due_s"], len(r["prompt"]), r["output_len"])
                for r in open_loop.schedule(SERVE, seed, 40, 49152)]

    assert work(1) == work(BIG)     # one trace; the seed draws the ids


def test_batches_deterministic_and_rows_differ():
    a = batches.batch(torch, TRAIN, BIG, 3, 50257, "cpu")
    b = batches.batch(torch, TRAIN, BIG, 3, 50257, "cpu")
    c = batches.batch(torch, TRAIN, BIG, 4, 50257, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (TRAIN["rows"], TRAIN["seq"] + 1)
    assert int(a.min()) >= 0 and int(a.max()) < 50257
    rows = {tuple(r.tolist()) for r in torch.cat([a, c])}
    assert len(rows) == 2 * TRAIN["rows"]
    assert batches.tokens_per_step(TRAIN) == TRAIN["rows"] * TRAIN["seq"]


def test_batches_accum_split():
    p = dict(TRAIN, accum_steps=2)
    a = batches.batch(torch, p, BIG, 0, 50257, "cpu")
    assert a.shape == (2, TRAIN["rows"] // 2, TRAIN["seq"] + 1)
    assert torch.equal(a.reshape(TRAIN["rows"], -1),
                       batches.batch(torch, TRAIN, BIG, 0, 50257, "cpu"))
