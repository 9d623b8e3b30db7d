"""The yardstick's arithmetic: percentiles with censored requests, the
frozen traffic model against the program's, FLOP counts against hand
counts, and the trace readers on made-up traces."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import flops, peaks, readers, spec
from benchmark.harness.model import make_params, param_count, sizes
from benchmark.harness.paged_traffic import kernel_traffic
from benchmark.harness.record import Run, Span
from benchmark.harness.stats import percentile
from benchmark.harness.trace import DeviceTrace
from benchmark.tests import tiny

SC2 = sizes(spec.load_config("starcoder2-3b"))
GPT = sizes(spec.load_config("gpt2-xl"))
MS = 1_000_000


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200):
        xs = list(rng.random(n))
        for q in (0, 50, 95, 100):
            assert math.isclose(percentile(xs, q), np.percentile(xs, q))


def _serve_run(reqs, window=(0, 100 * MS)):
    cell = spec.load_cell("starcoder2-3b.complete")
    run = Run("starcoder2-3b.complete", cell, {}, SC2, 1, 0.1, False)
    run.window, run.requests = window, reqs
    return run


def test_ttft_counts_censored_requests_with_their_wait():
    reqs = [dict(due=0, admit_t0=1 * MS, admit_t1=11 * MS, tokens_ns=[11 * MS]),
            dict(due=10 * MS, admit_t0=12 * MS, admit_t1=30 * MS,
                 tokens_ns=[30 * MS, 35 * MS, 45 * MS]),
            dict(due=60 * MS, tokens_ns=[]),              # still queued
            dict(due=90 * MS, failed="no slot", tokens_ns=[]),
            dict(due=95 * MS, admit_t0=96 * MS, admit_t1=120 * MS,
                 tokens_ns=[120 * MS]),                   # first token late
            dict(due=150 * MS, tokens_ns=[])]             # due after the end
    run = _serve_run(reqs)
    assert readers.ttft_ms(run) == [11.0, 20.0, 40.0, 10.0, 5.0]
    assert math.isclose(spec.metric_reader("ttft_p95_ms").read(run),
                        percentile([11, 20, 40, 10, 5], 95))
    assert readers.token_gaps_ms(run) == [5.0, 10.0]
    # admissions that ended inside the window
    assert math.isclose(
        spec.metric_reader("queue_wait_ms.complete").read(run), (1 + 2) / 2)
    # a traced run reads the host's times before the profiler started
    run.trace = DeviceTrace(50 * MS, 100 * MS, [], {})
    assert readers.ttft_ms(run) == [11.0, 20.0]
    assert readers.token_gaps_ms(run) == [5.0, 10.0]


def test_frozen_traffic_equals_the_programs():
    from elastic_tpu_agent_torch.workloads import paged_attention as pa

    cases = [dict(slots=32, table_blocks=260, block_size=16, kv_heads=2,
                  head_dim=128, itemsize=2, n_heads=24,
                  lengths=[513, 4160, 1, 0, 2049] + [700] * 27, window=4096),
             dict(slots=8, table_blocks=32, block_size=16, kv_heads=8,
                  head_dim=64, itemsize=4),
             dict(slots=3, table_blocks=2048, block_size=64, kv_heads=1,
                  head_dim=128, itemsize=2, n_heads=16, lengths=[5, 9000, 65],
                  window=37, splits=3)]
    for c in cases:
        assert kernel_traffic(**c) == pa.kernel_traffic(**c)


def test_attended_keys_by_hand():
    assert flops.attended_keys(4) == 1 + 2 + 3 + 4
    assert flops.attended_keys(6, window=3) == 1 + 2 + 3 + 3 + 3 + 3
    assert flops.attended_keys(3, window=5) == 6


def test_param_counts_by_hand():
    # StarCoder2-3B through the port: 30 x (wq 3072^2, wkv 3072 x 512, wo
    # 3072^2, w1 and w2 3072 x 12288, two scales) + embed and head 49152 x
    # 3072 + final scale
    layer = 2 * 3072 ** 2 + 3072 * 512 + 2 * 3072 * 12288 + 2 * 3072
    assert param_count(SC2)["total"] == 30 * layer + 2 * 49152 * 3072 + 3072
    assert param_count(SC2)["total"] == 3_180_518_400
    assert param_count(GPT)["total"] == 1_637_176_000
    assert param_count(GPT)["non_embedding"] == (
        1_637_176_000 - 50257 * 1600 - 1024 * 1600)


@pytest.mark.parametrize("name", ["starcoder2-3b", "gpt2-xl"])
def test_tree_is_the_ports_layout(name):
    from benchmark.drivers.common import port_config
    from elastic_tpu_agent_torch.workloads.weights import jax_layout_shapes

    s = sizes(tiny.config(name))
    tree = make_params(torch, s, 5, "cpu", torch.float32)
    want = jax_layout_shapes(port_config(torch, s))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape) if torch.is_tensor(t) else tuple(t)

    assert shapes(tree) == shapes(want)
    n = sum(x.numel() for x in (tree["embed"], tree["lm_head"],
                                tree["final_norm_scale"]))
    n += sum(x.numel() for layer in tree["layers"] for x in layer.values())
    n += tree["pos_embed"].numel() if "pos_embed" in tree else 0
    assert n == param_count(s)["total"]


def test_prefill_and_train_flops_by_hand():
    n = param_count(SC2)["non_embedding"]
    p = 100
    attn = 30 * 4 * 24 * 128 * (p * (p + 1) // 2)
    assert flops.prefill_flops(SC2, n, p) == 2 * n * p + attn
    g = param_count(GPT)["non_embedding"]
    step = 6 * g * 8 * 1024 + 3 * 48 * 4 * 8 * 25 * 64 * (1024 * 1025 // 2)
    assert flops.train_step_flops(GPT, g, 8, 1024) == step
    # about 8.0e13 a step, 81 ms at the bf16 peak
    assert 7.9e13 < step < 8.1e13


def test_decode_flops_and_mfu_by_hand():
    n = param_count(SC2)["non_embedding"]
    lengths = [600, 5000, 1]
    attn = 30 * 4 * 24 * 128 * (600 + 4096 + 1)
    assert flops.decode_step_flops(SC2, n, lengths) == 2 * n * 3 + attn
    g = param_count(GPT)["non_embedding"]
    assert flops.decode_step_flops(GPT, g, [900]) == (
        2 * g + 48 * 4 * 25 * 64 * 900)
    cell = spec.load_cell("starcoder2-3b.complete")
    run = Run("starcoder2-3b.complete", cell, {}, SC2, 1, 1.0, False)
    run.window = (0, 10**9)
    run.spans = [Span("step", 0, 20_000_000, {"lengths": lengths}),
                 Span("step", 30_000_000, 50_000_000, {"lengths": [7]}),
                 Span("admit", 60_000_000, 90_000_000)]
    work = flops.decode_step_flops(SC2, n, lengths) + flops.decode_step_flops(
        SC2, n, [7])
    want = 100 * work / (0.04 * 989e12)
    got = spec.metric_reader("decode_mfu.complete").read(run)
    assert math.isclose(got, want)
    run.spans = []
    assert readers.decode_mfu(run) is None


def test_flash_traffic_by_hand():
    f = flops.flash_fwd_traffic(8, 25, 25, 64, 1024, 2)
    assert f["flops"] == 4 * 8 * 25 * 64 * 1024 * 1025 // 2
    assert f["bytes"] == 4 * 8 * 1024 * 25 * 64 * 2 + 8 * 25 * 1024 * 4
    b = flops.flash_bwd_traffic(8, 25, 25, 64, 1024, 2)
    assert b["flops"] == 5 * f["flops"] // 2
    assert b["bytes"] == 7 * 8 * 1024 * 25 * 64 * 2 + 2 * 8 * 25 * 1024 * 4


def _trace(ops, t0=0, t1=100):
    return DeviceTrace(t0, t1, [(n, a, b, i) for i, (n, a, b) in
                                enumerate(ops)], {})


def test_busy_and_idle_gaps_merge_overlaps():
    tr = _trace([("k", 10, 20), ("k", 15, 30), ("m", 50, 60), ("k", 95, 120)])
    assert tr.busy_s() == (20 + 10 + 5) / 1e9
    assert tr.idle_gaps() == [(0, 10), (30, 50), (60, 95)]
    spans = [Span("step", 25, 55), Span("wait", 58, 100), Span("step", 60, 62)]
    assert tr.labelled_gaps(spans, 3) == [
        ["wait", 35e-9], ["step", 20e-9], ["harness", 10e-9]]


def test_paged_roofline_from_launches():
    cell = spec.load_cell("starcoder2-3b.complete")
    run = Run("starcoder2-3b.complete", cell, {}, SC2, 1, 1.0, True)
    lengths = [600, 4100, 1500]
    run.spans = [Span("step", 10, 20, {"lengths": lengths}),
                 Span("step", 30, 40, {"lengths": [l + 1 for l in lengths]})]
    ops = [("void paged_split_kernel<bf16>", 1000 * i, 1000 * i + 50_000)
           for i in range(60)]
    run.trace = DeviceTrace(0, 100_000_000, [(n, a, b, i) for i, (n, a, b)
                                             in enumerate(ops)], {})
    bound = 0.0
    for ls in (lengths, [l + 1 for l in lengths]):
        tr = kernel_traffic(3, 260, 16, 2, 128, 2, 24, ls, 4096)
        bound += 30 * max(tr["flops"] / 989e12, tr["bytes"] / 3.35e12)
    want = 100 * bound / (60 * 50e-6)
    got = spec.metric_reader("paged_decode_roofline.complete").read(run)
    assert math.isclose(got, want)
    run.trace.ops.pop()      # a launch short of one a layer a step: nothing
    assert readers.paged_decode_roofline(run) is None


def test_bound_takes_the_larger():
    assert peaks.bound_s(989e12, 0) == 1.0
    assert peaks.bound_s(0, 3.35e12) == 1.0
