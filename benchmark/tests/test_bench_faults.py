"""Whole runs of the harness on the CPU at the tiny sizes, with the look
for a card skipped: a sound run comes out correct, the control (fp8
products in the reference) reads well above the program, and each fault
a cell can have, planted in the timed path, makes ``correct`` come out
false under the cell's limits. ``--control`` judges the control and the
faults that the reference can stand in for under the same limits; at the
cells' own sizes ``test_bench_cuda.py`` holds each of them to not
correct."""

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny

SEED = 2**33 + 101


def _run(monkeypatch, capsys, cell, seconds="1.5", extra=()):
    tiny.install(monkeypatch)
    rc = bench_run.main(["--workload", cell, "--seed", str(SEED),
                         "--seconds", seconds, "--trace", "0", *extra],
                        device="cpu")
    out, err = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    # a --control run exits 5 where a control comes out correct
    passed = any(c["correct"] for c in res.get("controls", {}).values())
    assert rc == (5 if passed else 0), err[-3000:]
    return res, err


def _notes(err):
    line = [x for x in err.splitlines() if x.startswith("benchmark: notes")]
    return json.loads(line[-1].split(" ", 2)[2])


def test_serving_sound_run_and_control(monkeypatch, capsys, tmp_path):
    dump = tmp_path / "requests.json"
    res, err = _run(monkeypatch, capsys, "starcoder2-3b.complete",
                    extra=["--control", "--dump", str(dump)])
    reqs = json.loads(dump.read_text())["requests"]
    assert len(reqs) == res["attempted"]
    assert all(r["admit_t0"] >= r["due"] for r in reqs if "admit_t0" in r)
    assert res["correct"] is True, res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"ttft_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    gap = res["checks"]["widest_gap"]["value"]
    control = res["controls"]["control_fp8"]
    assert control["correct"] is False, control
    assert control["checks"]["widest_gap"]["value"] > 3 * gap
    assert "benchmark: control control_fp8 correct False" in err


def test_training_sound_run_and_control(monkeypatch, capsys):
    res, err = _run(monkeypatch, capsys, "gpt2-xl.train", "1",
                    extra=["--control"])
    assert res["correct"] is True, res
    assert {"train_tokens_per_s", "setup_s"} <= set(res["metrics"])
    assert _notes(err)["not_compared"]["loss_gap"] >= 0
    got = {k: c["value"] for k, c in res["checks"].items()}
    ctl = {name: {k: c["value"] for k, c in o["checks"].items()}
           for name, o in res["controls"].items()}
    # at this size the readings are smaller than at the cell's, and the fp8
    # control may stay within the limits; what holds at both is the
    # separation the limits rest on: the control reads 3x the program's
    # gradient gap, the half batch 10x its gaps, an unchanged state 1
    assert ctl["control_fp8"]["grad_gap"] > 3 * got["grad_gap"]
    for k in got:
        assert ctl["fault_half_batch"][k] > 10 * got[k]
    assert ctl["fault_state_unchanged"]["change_gap"] == 1.0
    for name in ("fault_half_batch", "fault_state_unchanged"):
        assert res["controls"][name]["correct"] is False, res["controls"]


def _wrong_tokens(monkeypatch):
    from elastic_tpu_agent_torch.workloads.serving import ServingEngine

    pick = ServingEngine._pick

    def altered(self, logits, *a):
        return (pick(self, logits, *a) + 1) % logits.shape[-1]

    monkeypatch.setattr(ServingEngine, "_pick", altered)


def _kv_never_written(monkeypatch):
    from elastic_tpu_agent_torch.workloads import serving

    monkeypatch.setattr(serving, "_pool_set", lambda pool, idx, val: None)


def _half_the_slots(monkeypatch):
    from elastic_tpu_agent_torch.workloads.serving import ServingEngine

    pick = ServingEngine._pick

    def half(self, logits, *a):       # every other live row never computed
        nxt = pick(self, logits, *a)
        nxt[sorted(self._slot_of.values())[::2]] = 0
        return nxt

    monkeypatch.setattr(ServingEngine, "_pick", half)


@pytest.mark.parametrize("plant", [_wrong_tokens, _kv_never_written,
                                   _half_the_slots])
def test_serving_faults_fail(monkeypatch, capsys, plant):
    plant(monkeypatch)
    res, _ = _run(monkeypatch, capsys, "starcoder2-3b.complete")
    assert res["correct"] is False, res["checks"]


def _state_unchanged(monkeypatch):
    from elastic_tpu_agent_torch.workloads.transformer import AdamW

    monkeypatch.setattr(AdamW, "update_", lambda self, g, st, p: None)


def _half_the_batch(monkeypatch):
    from elastic_tpu_agent_torch.workloads import transformer as tf

    whole = tf.loss_and_grads

    def half(params, tokens, cfg, device="cuda"):
        tokens = torch.as_tensor(tokens)
        return whole(params, tokens[: tokens.shape[0] // 2], cfg, device)

    monkeypatch.setattr(tf, "loss_and_grads", half)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_batch])
def test_training_faults_fail(monkeypatch, capsys, plant):
    plant(monkeypatch)
    res, _ = _run(monkeypatch, capsys, "gpt2-xl.train", "1")
    assert res["correct"] is False, res["checks"]
