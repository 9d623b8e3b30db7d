#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, runtime and
shared-prefix serving slices on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without a device it prints no result and exits
2. A failed check is printed and the run goes on, so that every reading
shows; it then exits 1 before the summary lines. Phases:

1. build the hand-written CUDA kernels from ``elastic_tpu_agent_torch/
   csrc`` (nvcc, sm_90a) into the git-ignored ``_build/`` directory;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (and at a few edges: q/k/v as strided views of one
   fused projection, a paged row of length 0, the largest query group at
   head_dim 128 and block 64, paged tables whose rows name the same first
   8 blocks as a prefix-cache hit maps them (timed too), the backward at
   1024 positions, one kv head,
   windows 1 and 64, 17 positions and batch 1, a misaligned bf16 dO view
   that must raise), and time the kernel, the plain version and one
   PyTorch library call that computes the same function (for the flash
   backward kernels: the backward of scaled_dot_product_attention), all
   three by device time: CUDA events around calls queued behind a sleep
   kernel, so that the host's gaps are not timed (the kernel also by
   CUDA events around calls the host paces);
3. the flagship forward at the full width of the runner's ``small``
   preset, through the flash kernel, against the same model forced onto
   the reference attention;
4. the ServingEngine at the same preset: 16 requests (admit and enqueue,
   greedy and sampled) through the paged-decode kernel; then a float32
   two-layer copy whose kernel-path greedy streams must equal the gather
   path's and ``generate()``'s;
5. the train step at the same preset (batch 8, seq 256, lr 1e-3, f32
   params computed in bf16: the JAX runner's defaults) for 20 steps on
   one fixed batch, through the flash forward and both backward kernels,
   against the same run on the reference attention; then a float32
   two-layer copy whose kernel-path gradients must equal the reference
   path's; a short torch.profiler pass gives the device-busy share
   (reported as not measured when the profiler sees no device time);
6. the in-pod runtime: ``runner.main`` in this process on the card at the
   same preset, each report read from its printed JSON line. Train: 20
   steps with evals and checkpoints on a Zipf-distributed token file,
   launch counts of the three attention kernels over exactly that run
   (its warm-up pass included), eval loss falling, a flight-recorder
   record per step; decode mode from that checkpoint; resume: 10 steps,
   then the same command again, whose final loss must equal the
   uninterrupted run's within RESUME_TOL; pre-copy drain: an alloc spec
   with the drain already stamped, delta rounds while training goes on
   (each split into the copy to the host and the rest), a final delta, an
   ack whose digest is the verified chain, and a resume from that chain;
7. MoE (the same preset with 4 experts in every second layer, the
   repo's MoE count): the layer held against the JAX layer's one-hot
   einsum form on the card (float32: outputs, aux loss, routes and
   gradients; bf16: outputs); the forward at ``[8,256]`` through the
   flash kernel against reference attention; 20 train steps through the
   flash forward and both backward kernels against the same run on
   reference attention, with the aux loss, drop rate and imbalance; 16
   requests on the kernel-path engine; a float32 two-layer copy whose
   kernel-path streams must equal the gather path's (and, at the
   drop-free capacity factor, ``generate()``'s) and whose gradients must
   match the reference path's (routes that differ between the runs are
   counted);
8. int8 at the dense preset: ``quantize_params`` on the card byte-equal
   to the CPU's, ``generate`` on the int8 weights (tokens/s, greedy
   agreement with the bf16 stream), a ``kv_int8`` engine over 16 requests
   (the gather path: no paged-decode launch), ``runner --mode decode
   --int8``;
9. the engine's flight recorder and lifecycle drain: 16 admitted
   requests give one ``serving_admit`` record each and one
   ``serving_step`` per step; then a drain stamped into the alloc spec
   refuses admission, ``drain_serving`` finishes the streams and writes
   the ack;
10. shared prefixes at the dense preset: 16 requests sharing a 128-token
   system prompt (tails of 8-64 tokens; admit and enqueue, greedy and
   sampled) on the kernel-path engine without and with ``prefix_cache``
   (prefilled tokens, hits, TTFT p50 from the admission call to the first
   token, tokens/s, paged launches = layers x decode steps, the pool
   holding only the cache's blocks after every release and none after
   ``clear()``); ``register_prefix`` and 8 ``admit(prefix=)`` on the same
   engine; a prefill-role and a decode-role engine over one
   ``SharedKVPool`` sharing one ``RequestObservatory`` (16 adoptions, at
   most a block of decode-side prefill each, conservation within 1 ms,
   one id per request, TTFT/TPOT per SLO class); 8 streams decoded 10
   steps, then ``drain_serving(handoff=True)`` acked through a watcher
   and a peer engine adopting and finishing them; a float32 two-layer
   copy whose greedy streams must be the same over the uncached, cached,
   explicit-prefix, disaggregated and handed-off runs and ``generate()``;
11. summary: the device time of the whole bf16 backward (delta, dK/dV
   and dQ) against SDPA's whole backward, a ``paths`` JSON line, a
   ``kernels`` JSON line, the card's name and power limit as nvidia-smi
   reports them, and the result line.

``--profile`` adds a torch.profiler pass over one forward, 20 decode
steps and 3 train steps (device-busy share and top device ops, printed).
``--out DIR``
writes the full report to ``DIR/chip_smoke.json`` and, with
``--profile``, the profiler tables and chrome traces to ``DIR/profile/``.

Weights are random, in the JAX ``init_params`` layout, made with numpy
from ``SEED`` and loaded through the weight bridge. Nothing of JAX or of
the JAX package is imported.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
# elastic_tpu_agent/workloads/runner.py PRESETS["small"]
SMALL = dict(vocab=32768, d_model=512, n_heads=8, n_layers=8, d_ff=2048)
# H100 SXM data sheet: memory rate and dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# max |kernel - plain| on the card. float32 outputs differ by summation
# order only. bf16 limits sit between the sound kernels' readings and
# those of kernels with a planted fault, run the same way (PERF.md):
# flash_fwd o gave 3.9e-3 (one ulp near 1; the plain version rounds p to
# bf16 as the kernel does) and 1.6e-2 without the kernel's cast of p;
# paged_decode keeps its math in f32 and rounds only the output: up to
# 4.9e-4 (one output ulp in [1/16, 1/8)), and 4.4e-2 attending one
# position short of the length.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
PAGED_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
LSE_TOL = 1e-3
# bf16 logits, flash kernel vs reference attention through 8 layers: the
# two round at different places (the reference rounds scores and
# normalised probabilities to bf16, the kernel keeps f32 scores). Sound
# kernels gave 0.027; a causal mask dropped or shifted in the kernel gave
# 2.3 to 2.8.
FORWARD_BF16_TOL = 0.06
FORWARD_F32_TOL = 1e-3  # same comparison in float32
# flash backward kernels, for each of dq, dk, dv: max |kernel - plain|
# over max |plain| (BWD_TOL), and mean |kernel - plain| over mean |plain|
# (BWD_MEAN_TOL), which sees a rounding fault that moves every element by
# less than the largest element's ulp. float32 differs by summation order
# only. In bf16 one rounding that lands the other way on the largest
# element is an ulp, up to 2^-8 = 3.9e-3 of it, so the max limit is two
# ulps; the mean limit sits between the sound kernels' readings and those
# of kernels with a planted fault (PERF.md, Findings): the sound wgmma
# kernels gave up to 2.6e-3 (max) and 4.6e-6 (mean); the planted faults
# 0.95 or more (max) and 0.18 or more (mean). (The FMA kernels' fault "ds
# not rounded before dK", 1.6e-3 mean, cannot be planted in the wgmma
# ones: ds reaches the product only as a bf16 register operand.)
BWD_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
BWD_MEAN_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
# bf16 training losses over 20 steps, flash kernels vs reference attention
# (they round scores and probabilities at different places): sound
# kernels gave 0.045-0.046; delta dropped in dQ gave 0.235, the q-tile lower
# bound one tile late 1.26, lse/delta read by row 2.17 (PERF.md, Findings).
TRAIN_BF16_TOL = 0.2
# float32 two-layer gradients, kernel path vs reference path, relative to
# each leaf's largest gradient (summation order only)
TRAIN_GRAD_F32_TOL = 1e-4
TRAIN_STEPS = 20
# |final loss of a run resumed at step 10 - the uninterrupted run's|: none
# at all. The resumed run restores the f32 params and optimizer state bit
# for bit and reads the same batches at the same schedule counts, so it
# repeats the same computation with the same kernels on the same shapes,
# and no op on the path sums in thread order (the flash backward has no
# atomics; the embedding gradient's index_put sorts its indices; cuBLAS is
# deterministic on one stream): every sound run gave a gap of exactly 0.
# Restore faults planted in the runner (planted_faults.py F13-F15) gave:
# optimizer state left at its init 0.051, step count reset 0.036, second
# moment reset 51.8.
RESUME_TOL = 0.0
RUNTIME_STEPS = 20
EVAL_BATCHES = 2
# the MoE cell: the small preset with the repo's MoE count
# (__graft_entry__.py's MoE leg) and the config's defaults (every second
# layer, capacity factor 1.25, aux coefficient 0.01)
MOE_EXPERTS = 4
# moe_mlp against the JAX layer's one-hot einsum form on the same inputs:
# each slot holds one token, so the einsums' sums have one nonzero term
# and the two forms differ only where the expert matmuls sum in another
# order; relative to the largest element (outputs, aux, each gradient).
# Sound: outputs and aux exactly equal, gradients 5.7e-7 at most; the MoE
# faults planted in moe.py (PERF.md, Findings): the gate dropped 1.18 or
# more, capacity C + 1 0.0495 or more (and a route differing)
MOE_LAYER_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# bf16 MoE model, flash kernels vs reference attention. A route that
# flips between the two runs (29-48 of 8,192 with sound kernels) changes
# that token's MLP output outright, so the forward's logits are compared
# on their mean |difference|: sound attention 0.0043-0.0083, the causal
# mask one column late (F9) 0.0495. Train losses over 20 steps drift apart
# as flipped routes compound: with sound attention kernels 0.110-0.258
# (the sound tree and the runs with MoE faults, whose kernels are sound),
# with backward or forward faults 0.594 (F9), 1.65 (F8), 1.90 (F12); F6
# (0.337) sits below the limit and fails the dQ check and the dense gap.
MOE_FORWARD_BF16_MEAN_TOL = 0.02
MOE_TRAIN_BF16_TOL = 0.5
# float32 two-layer gradients, as the dense cell's: sound 1.10e-6 to
# 1.14e-6 with no route flipped; no planted fault reaches the f32 kernels
MOE_GRAD_F32_TOL = 1e-4


FAILURES: list = []


def fail(msg: str) -> None:
    """Record a failed check; the run goes on so that every reading is
    printed, and exits non-zero at the end."""
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    FAILURES.append(msg)


def cuda_ms(fn, warmup: int = 5, iters: int = 50) -> float:
    """Mean time of fn() in ms over ``iters`` back-to-back calls (CUDA
    events, after warm-up): device time plus any gap the host leaves."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, reps: int = 20) -> tuple:
    """Device time of one fn() in ms: CUDA events around ``reps`` calls
    that the host queued while a sleep kernel held the card, so that the
    calls run back to back on the card and the host's gaps between them
    are not timed (CUDA events around host-bound calls would time them).
    Returns (ms, queued): ``queued`` is False when the host had not queued
    every call before the card reached the first, even after a longer
    sleep and fewer calls; the time then includes host gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0      # the host's time to queue reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = int(host_s * 4e9) + 2_000_000  # ~2x that at <= 2 GHz
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()          # the card still sleeping
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        if queued:
            break
        cycles *= 4
        reps = max(5, reps // 2)            # fewer launches in the queue
    return ms, queued


def timings(torch, fn, plain, library=None) -> dict:
    """Device ms of the kernel, its plain version and the library call
    (the kernels line), with the kernel's CUDA-event ms over calls the
    host paces (``unqueued_ms``) beside."""
    out = {}
    for key, f in (("ms", fn), ("plain_ms", plain), ("library_ms", library)):
        if f is None:
            out[key] = None
            continue
        out[key], queued = device_ms(torch, f)
        if not queued:
            print(f"chip_smoke: {key} could not be queued ahead of the card; "
                  "it includes host gaps", file=sys.stderr)
    out["unqueued_ms"] = cuda_ms(fn)
    return out


def randn(torch, rng, shape, dtype, dev):
    return torch.tensor(rng.normal(size=shape), dtype=dtype, device=dev)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(torch, A, dev):
    """Flash forward vs its plain version; returns the kernel's record."""
    rng = np.random.default_rng(SEED)
    b, s, n, h = 8, 256, 8, 64     # the forward phase's attention shape
    cases = [
        ("bf16 causal", torch.bfloat16, A.FlashConfig()),
        ("bf16 window 96", torch.bfloat16, A.FlashConfig(window=96)),
        ("bf16 fused-view", torch.bfloat16, A.FlashConfig()),
        ("f32 causal", torch.float32, A.FlashConfig()),
        ("f32 non-causal", torch.float32, A.FlashConfig(causal=False)),
    ]
    err_max = 0.0
    for label, dtype, fc in cases:
        if "fused" in label:   # views of one [b, s, 3, n, h] projection
            qkv = randn(torch, rng, (b, s, 3, n, h), dtype, dev)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (randn(torch, rng, (b, s, n, h), dtype, dev)
                       for _ in range(3))
        o, lse = A.flash_attention_with_lse(q, k, v, fc)
        o_ref, lse_ref = A.flash_attention_plain(q, k, v, fc)
        torch.cuda.synchronize()
        e_o = (o.float() - o_ref.float()).abs().max().item()
        e_l = (lse - lse_ref).abs().max().item()
        name = str(dtype).split(".")[-1]
        print(f"flash_fwd {label} [{b},{s},{n},{h}]: max|o| err {e_o:.3g}, "
              f"max|lse| err {e_l:.3g}")
        if not (e_o <= FLASH_TOL[name] and e_l <= LSE_TOL):
            fail(f"flash_fwd {label}: o err {e_o}, lse err {e_l}")
        err_max = max(err_max, e_o, e_l)
    # timing at the main path's shape
    q, k, v = (randn(torch, rng, (b, s, n, h), torch.bfloat16, dev)
               for _ in range(3))
    fc = A.FlashConfig()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = timings(
        torch, lambda: A.flash_attention_with_lse(q, k, v, fc),
        lambda: A.flash_attention_plain(q, k, v, fc),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    nbytes = 4 * b * s * n * h * 2 + b * n * s * 4      # q, k, v, o + lse
    flops = 4 * b * n * h * (s * (s + 1) // 2)          # QK^T and PV, causal
    t, by = bound(nbytes, flops, "bfloat16")
    return dict(
        name="flash_fwd", route="cuda",
        source="elastic_tpu_agent_torch/csrc/flash_fwd.cu",
        replaces="elastic_tpu_agent/workloads/attention.py:100",
        launches=None, max_abs_err=err_max, bound_ms=t, bound_by=by,
        shape=f"[{b},{s},{n},{h}] bf16 causal", **times,
    )


def _bwd_inputs(torch, A, rng, dev, shape, dtype, fc, dlse):
    b, s, n, g, h = shape
    q, do = (randn(torch, rng, (b, s, n, h), dtype, dev) for _ in range(2))
    k, v = (randn(torch, rng, (b, s, g, h), dtype, dev) for _ in range(2))
    o, lse = A.flash_attention_plain(q, k, v, fc)
    dl = randn(torch, rng, (b, n, s), torch.float32, dev) if dlse else None
    return q, k, v, do, lse, A.flash_bwd_delta(o, do, dl)


def check_flash_bwd(torch, A, dev):
    """The backward kernels vs their plain versions; returns their
    records (dK/dV, dQ)."""
    rng = np.random.default_rng(SEED + 6)
    b, s, n, h = 8, 256, 8, 64     # the training phase's attention shape
    fc = A.FlashConfig()
    cases = [
        ("bf16 causal", torch.bfloat16, (b, s, n, n, h), fc, False),
        ("bf16 window 37", torch.bfloat16, (b, s, n, n, h),
         A.FlashConfig(window=37), False),
        ("bf16 GQA g2", torch.bfloat16, (b, s, n, 2, h), fc, False),
        ("bf16 dlse", torch.bfloat16, (b, s, n, n, h), fc, True),
        ("bf16 h128 s200", torch.bfloat16, (2, 200, n, n, 128), fc, False),
        # the wgmma instances' edges: 16 tiles queued per CTA (each ring's
        # phase wraps), one kv head for 8 query heads, windows of 1 and of
        # one tile, one ragged tile, batch 1. Window 1 leaves a row only
        # itself (p = 1, dp = delta up to rounding), so without an lse
        # cotangent its dq and dk would be rounding noise.
        ("bf16 s1024", torch.bfloat16, (2, 1024, n, n, h), fc, False),
        ("bf16 GQA g1", torch.bfloat16, (b, s, n, 1, h), fc, False),
        ("bf16 window 1", torch.bfloat16, (b, s, n, n, h),
         A.FlashConfig(window=1), True),
        ("bf16 window 64", torch.bfloat16, (b, s, n, 2, h),
         A.FlashConfig(window=64), True),
        ("bf16 s17", torch.bfloat16, (b, 17, n, n, h), fc, False),
        ("bf16 batch 1", torch.bfloat16, (1, s, n, n, h), fc, False),
        ("f32 causal", torch.float32, (b, s, n, n, h), fc, False),
        ("f32 non-causal GQA h128 s200", torch.float32, (2, 200, n, 2, 128),
         A.FlashConfig(causal=False), True),
    ]
    plains = {"flash_bwd_dkdv": A.flash_bwd_dkdv_plain,
              "flash_bwd_dq": A.flash_bwd_dq_plain}
    kerns = {"flash_bwd_dkdv": A.flash_bwd_dkdv,
             "flash_bwd_dq": A.flash_bwd_dq}
    abs_max = dict.fromkeys(kerns, 0.0)
    for label, dtype, shape, cfg, dlse in cases:
        args = _bwd_inputs(torch, A, rng, dev, shape, dtype, cfg, dlse)
        name = str(dtype).split(".")[-1]
        for kname, kern in kerns.items():
            got, want = kern(*args, cfg), plains[kname](*args, cfg)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errs, rels, means = [], [], []
            for x, y in zip(got, want):
                d, y = (x.float() - y.float()).abs(), y.float().abs()
                errs.append(d.max().item())
                rels.append(errs[-1] / y.max().item())
                means.append((d.mean() / y.mean()).item())
            print(f"{kname} {label} {list(shape)}: max|err| "
                  + ", ".join(f"{e:.3g}" for e in errs) + "; relative max "
                  + ", ".join(f"{r:.3g}" for r in rels) + "; relative mean "
                  + ", ".join(f"{r:.3g}" for r in means))
            if not (max(rels) <= BWD_TOL[name]
                    and max(means) <= BWD_MEAN_TOL[name]):
                fail(f"{kname} {label}: relative max {rels}, mean {means}")
            abs_max[kname] = max(abs_max[kname], *errs)
    # a bf16 dO view whose head stride (68 elements) is no 16-byte
    # multiple: TMA cannot read it, so both wrappers raise before a launch
    args = _bwd_inputs(torch, A, rng, dev, (b, s, n, n, h), torch.bfloat16,
                       fc, False)
    pad = torch.zeros((b, s, n, h + 4), dtype=torch.bfloat16, device=dev)
    pad[..., :h] = args[3]
    bad = args[:3] + (pad[..., :h],) + args[4:]
    counters = (A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    before = [c.launches for c in counters]
    raised = []
    for kname, kern in kerns.items():
        try:
            kern(*bad, fc)
        except ValueError:
            raised.append(kname)
    torch.cuda.synchronize()
    launched = [c.launches - n0 for c, n0 in zip(counters, before)]
    print(f"flash_bwd misaligned bf16 dO view: ValueError from {raised}, "
          f"launches {launched}")
    if len(raised) != len(kerns) or any(launched):
        fail(f"misaligned bf16 dO: raised {raised}, launches {launched}")

    # timing at the main path's shape, bf16 causal
    args = _bwd_inputs(torch, A, rng, dev, (b, s, n, n, h), torch.bfloat16,
                       fc, False)
    q, k, v, do = args[:4]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()

    def library():                     # dq, dk and dv together
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    pairs = b * n * (s * (s + 1) // 2)                 # causal (q, key) pairs
    in_bytes = 4 * b * s * n * h * 2 + 2 * b * n * s * 4  # q,k,v,dO; lse,delta
    out_bytes = {"flash_bwd_dkdv": 2 * b * s * n * h * 2,
                 "flash_bwd_dq": b * s * n * h * 2}
    flops = {"flash_bwd_dkdv": 4 * 2 * h * pairs,  # QK^T dO.V^T P^T.dO dS^T.Q
             "flash_bwd_dq": 3 * 2 * h * pairs}    # QK^T dO.V^T dS.K
    line = {"flash_bwd_dkdv": "attention.py:188", "flash_bwd_dq":
            "attention.py:249"}
    out_recs = []
    for kname, kern in kerns.items():
        times = timings(torch, lambda: kern(*args, fc),
                        lambda: plains[kname](*args, fc), library)
        t, by = bound(in_bytes + out_bytes[kname], flops[kname], "bfloat16")
        out_recs.append(dict(
            name=kname, route="cuda",
            source="elastic_tpu_agent_torch/csrc/flash_bwd.cu",
            replaces=f"elastic_tpu_agent/workloads/{line[kname]}",
            launches=None, max_abs_err=abs_max[kname], bound_ms=t,
            bound_by=by, shape=f"[{b},{s},{n},{h}] bf16 causal; library_ms "
            "is SDPA's whole backward (dq, dk, dv)", **times,
        ))
    # the whole bf16 backward as the autograd Function runs it: delta, then
    # both kernels
    o = A.flash_attention_plain(q, k, v, fc)[0]

    def whole():
        delta = A.flash_bwd_delta(o, do)
        A.flash_bwd_dkdv(q, k, v, do, args[4], delta, fc)
        A.flash_bwd_dq(q, k, v, do, args[4], delta, fc)

    whole_rec = dict(shape=f"[{b},{s},{n},{h}] bf16 causal",
                     ms=device_ms(torch, whole)[0],
                     delta_ms=device_ms(
                         torch, lambda: A.flash_bwd_delta(o, do))[0],
                     sdpa_backward_ms=out_recs[0]["library_ms"])
    return (*out_recs, whole_rec)


def _paged_inputs(torch, rng, dev, dtype, g, r, full, h=64, bs=16, nb=32,
                  shared=0):
    """q, pools, table and lengths for 8 slots. Every row's table is its
    own blocks, except that with ``shared`` the first ``shared`` entries
    of every row name row 0's blocks, as a prefix-cache hit maps them."""
    slots = 8                    # serving phase: max_len 512 / bs 16
    n_blocks = slots * nb + 1
    q = randn(torch, rng, (slots, g * r, h), dtype, dev)
    pk, pv = (randn(torch, rng, (n_blocks, bs, g, h), dtype, dev)
              for _ in range(2))
    table = rng.permutation(np.arange(1, n_blocks)).reshape(slots, nb)
    table[1:, :shared] = table[0, :shared]
    lengths = (np.full(slots, nb * bs) if full
               else rng.integers(1, nb * bs + 1, slots))
    if not full:
        lengths[3] = 0           # attends nothing: the mean of V, as JAX
    return (q, pk, pv,
            torch.tensor(table.astype(np.int32), device=dev),
            torch.tensor(lengths.astype(np.int32), device=dev))


def check_paged(torch, PA, dev):
    """Paged decode vs its plain version; returns the kernel's record."""
    rng = np.random.default_rng(SEED + 1)
    err_max = 0.0
    # the last two cases: the prefix cell's tables, whose rows name the
    # same 8 physical blocks (the 128-token system prompt) first
    for dtype in (torch.bfloat16, torch.float32):
        for g, r, window, h, bs, nb, shared in ((8, 1, 0, 64, 16, 32, 0),
                                                (2, 4, 0, 64, 16, 32, 0),
                                                (2, 4, 100, 64, 16, 32, 0),
                                                (1, 16, 0, 128, 64, 8, 0),
                                                (8, 1, 0, 64, 16, 32, 8),
                                                (2, 4, 100, 64, 16, 32, 8)):
            q, pk, pv, table, lengths = _paged_inputs(
                torch, rng, dev, dtype, g, r, False, h, bs, nb, shared
            )
            got = PA.paged_decode_attention(
                q, pk, pv, table, lengths, g, window=window)
            want = PA.paged_decode_attention_reference(
                q, pk, pv, table, lengths, g, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            name = str(dtype).split(".")[-1]
            label = (f"paged_decode {name} g{g} r{r} h{h} bs{bs} window "
                     f"{window} shared {shared} splits "
                     f"{PA.paged_splits(8, g, nb)}")
            print(f"{label}: max err {err:.3g}")
            if not err <= PAGED_TOL[name]:
                fail(f"{label}: {err}")
            err_max = max(err_max, err)
    # timing: 8 slots x 512 positions x 8 kv heads x 64, bf16
    q, pk, pv, table, lengths = _paged_inputs(
        torch, rng, dev, torch.bfloat16, 8, 1, full=True
    )
    times = timings(
        torch, lambda: PA.paged_decode_attention(q, pk, pv, table, lengths, 8),
        lambda: PA.paged_decode_attention_reference(
            q, pk, pv, table, lengths, 8))
    tr = PA.kernel_traffic(8, 32, 16, 8, 64, 2, n_heads=8,
                           lengths=lengths.tolist())  # the H100's grid
    # the bound counts what the function must move: K/V rows, q, out and
    # the table once; the partials (tr["partial_bytes"]) are the kernel's
    t, by = bound(tr["bytes"], tr["flops"], "bfloat16")
    # the same shape with every row's first 8 entries naming row 0's
    # blocks (a prefix-cache hit on the 128-token system prompt)
    q, pk, pv, table, lengths = _paged_inputs(
        torch, rng, dev, torch.bfloat16, 8, 1, full=True, shared=8
    )
    shared_ms = device_ms(torch, lambda: PA.paged_decode_attention(
        q, pk, pv, table, lengths, 8))[0]
    print(f"paged_decode shared table (8 rows x 8 shared blocks): device ms "
          f"{shared_ms:.4g}")
    return dict(
        name="paged_decode", route="cuda",
        source="elastic_tpu_agent_torch/csrc/paged_decode.cu",
        replaces="elastic_tpu_agent/workloads/paged_attention.py:38",
        launches=None, max_abs_err=err_max, bound_ms=t, bound_by=by,
        shape=f"8 slots x 512 positions, g 8, r 1, h 64, bs 16, bf16; grid "
        f"{tr['grid']}, kernel bytes {tr['kernel_bytes']}",
        shared_table_ms=shared_ms, **times,
    )


def run_forward(torch, W, A, cfg, params, dev):
    """The flagship forward through the flash kernel: launches counted
    over exactly one main-path call, logits against attn='reference'."""
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    A.FLASH_FWD.launches = 0
    logits = W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    launches = A.FLASH_FWD.launches
    if launches != cfg.n_layers:
        fail(f"forward launched flash_fwd {launches}x, want {cfg.n_layers}")
    ref = W.forward(params, tokens, dataclasses.replace(cfg, attn="reference"),
                    device=dev)
    if tuple(logits.shape) != (8, 256, cfg.vocab):
        fail(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail("non-finite logits")
    if logits.requires_grad:
        fail("the serving forward recorded an autograd graph")
    err = (logits.float() - ref.float()).abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"forward small preset [8,256] bf16: flash_fwd launches {launches}, "
          f"max|logits - reference| {err:.3g}, argmax agreement {agree:.4f}")
    if not err <= FORWARD_BF16_TOL:
        fail(f"forward logits vs reference: {err}")
    for _ in range(3):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / reps * 1e3
    ref_cfg = dataclasses.replace(cfg, attn="reference")
    ref_ms = cuda_ms(lambda: W.forward(params, tokens, ref_cfg, device=dev),
                     2, 10)
    return launches, dict(
        batch=8, seq=256, ms=fwd_ms, reference_attention_ms=ref_ms,
        max_abs_err_vs_reference=err, argmax_agreement=agree,
        flash_launches=launches,
    )


def forward_f32_check(torch, W, cfg32, params32, dev):
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.tensor(rng.integers(0, cfg32.vocab, size=(4, 200)),
                          device=dev)
    got = W.forward(params32, tokens, cfg32, device=dev)
    ref = W.forward(params32, tokens,
                    dataclasses.replace(cfg32, attn="reference"), device=dev)
    err = (got - ref).abs().max().item()
    print(f"forward f32 2-layer [4,200]: max|logits - reference| {err:.3g}")
    if not err <= FORWARD_F32_TOL:
        fail(f"f32 forward vs reference: {err}")
    return err


def serve(W, eng, prompts, kinds, new_tokens, step_times=None, ttft=None):
    """Run ``prompts`` through ``eng`` (kinds[i] = (admit?, request
    kwargs)), releasing each request at ``new_tokens`` tokens; returns
    the streams in request order. ``ttft`` (a dict) gets each request's
    host seconds from its admission call to its first token."""
    queue = list(range(len(prompts)))
    rid_of, streams, t_admit = {}, {}, {}
    while queue or rid_of:
        st = eng.stats()
        free = st["slots"] - st["live_requests"] - st["pending_prefills"]
        while queue and free > 0:
            i = queue.pop(0)
            use_admit, kw = kinds[i]
            fn = eng.admit if use_admit else eng.enqueue
            t_admit[i] = time.perf_counter()
            rid = fn(prompts[i], **kw)
            rid_of[rid] = i
            if ttft is not None and eng.stream(rid):
                ttft[i] = time.perf_counter() - t_admit[i]
            free -= 1
        t0 = time.perf_counter()
        out = eng.step()
        if step_times is not None:
            step_times.append(time.perf_counter() - t0)
        if ttft is not None:
            for rid in out:
                if rid_of.get(rid) is not None and rid_of[rid] not in ttft:
                    ttft[rid_of[rid]] = time.perf_counter() - t_admit[
                        rid_of[rid]]
        for rid, i in list(rid_of.items()):
            if rid in eng.finish_reason or len(eng.stream(rid)) >= new_tokens:
                streams[i] = eng.release(rid)
                del rid_of[rid]
    return [streams[i] for i in range(len(prompts))]


def _serving_requests(cfg, seed):
    """16 prompts of 16-200 tokens and their kinds (admit or enqueue,
    greedy or sampled), as phase 4 draws them."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).tolist()
               for n in rng.integers(16, 201, size=16)]
    kinds = [(i % 4 < 2, {} if i % 2 == 0 else dict(temperature=0.8,
                                                     top_k=50))
             for i in range(16)]
    return prompts, kinds


def run_serving(torch, W, PA, cfg, params, tree, dev):
    n_req, new_tokens = 16, 64
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev)
    if not eng.paged_kernel:
        fail("paged_kernel auto did not resolve ON on the card")
    step_times = []
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, new_tokens, step_times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.PAGED_DECODE.launches
    steps = eng.decode_steps_total
    if launches != cfg.n_layers * steps or steps == 0:
        fail(f"paged_decode launched {launches}x over {steps} decode steps")
    for i, s in enumerate(streams):
        if len(s) != new_tokens or not all(0 <= t < cfg.vocab for t in s):
            fail(f"request {i}: stream of {len(s)} tokens {s[:4]}...")
    if eng.used_blocks != 0:
        fail(f"{eng.used_blocks} pool blocks leaked")
    tokens = n_req * new_tokens
    st_ms = np.asarray(step_times) * 1e3
    print(f"serving small preset: {n_req} requests x {new_tokens} tokens, "
          f"{steps} decode steps, paged_decode launches {launches}, "
          f"{tokens / wall:.1f} tokens/s, step p50 {np.median(st_ms):.2f} ms")

    # float32 two-layer copy: kernel path vs gather path vs generate()
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    params32 = W.params_from_jax(tree32, cfg32, device=dev)
    f32_err = forward_f32_check(torch, W, cfg32, params32, dev)
    few = [p[:40] for p in prompts[:8]]
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    runs = {}
    for paged in (True, False):
        e = W.ServingEngine(params32, cfg32, slots=8, max_len=512,
                            prompt_buckets=(16, 64, 256), paged_kernel=paged,
                            device=dev)
        runs[paged] = serve(W, e, few, greedy, 32)
    oracle = [W.generate(params32, [p], cfg32, 32, device=dev)[0, len(p):]
              .tolist() for p in few]
    same = runs[True] == runs[False] == oracle
    print("serving f32 2-layer: kernel path == gather path == generate(): "
          f"{same}")
    if not same:
        fail("f32 kernel-path streams differ from gather path / generate()")
    return launches, dict(
        requests=n_req, new_tokens=new_tokens, decode_steps=steps,
        wall_s=wall, tokens_per_s=tokens / wall,
        step_ms_mean=float(st_ms.mean()), step_ms_p50=float(np.median(st_ms)),
        paged_launches=launches, f32_forward_err=f32_err,
        f32_streams_equal=same,
    )


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _train(torch, W, cfg, tree, dev, tokens, steps):
    """``steps`` train steps from the bridged f32 params; returns the
    losses, the host-clock step times (each ends in the loss's copy to
    the host) and a closure that runs one more step."""
    params = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    step, _, opt = W.make_train_step(cfg, learning_rate=1e-3, device=dev)
    state = opt.init(params)
    losses, times = [], []

    def one():
        loss = step(params, state, tokens)[2].item()
        losses.append(loss)
        return loss

    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    return losses, times, one


def run_train(torch, W, A, cfg, tree, dev):
    """The train step through the flash kernels: launches counted over
    exactly the TRAIN_STEPS main-path steps, losses against the same run on
    reference attention, f32 gradients against the reference path's."""
    rng = np.random.default_rng(SEED + 7)
    batch, seq = 8, 256
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(batch, seq + 1)),
                          device=dev)
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    for kern in kerns:
        kern.launches = 0
    losses, times, one = _train(torch, W, cfg, tree, dev, tokens, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {kern.symbol: kern.launches for kern in kerns}
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        fail(f"train launches {launches}, want {want} each")
    if not all(np.isfinite(losses)):
        fail(f"non-finite train losses {losses}")
    if not losses[-1] < 0.9 * losses[0]:
        fail(f"train loss {losses[0]} -> {losses[-1]}: not falling")
    step_ms = np.asarray(times) * 1e3
    p50 = float(np.median(step_ms))
    busy = _profiled(torch, one, 3)[1] or None   # None: no device time seen
    ref_losses, ref_times, _ = _train(
        torch, W, dataclasses.replace(cfg, attn="reference"), tree, dev,
        tokens, TRAIN_STEPS)
    gap = float(np.max(np.abs(np.asarray(losses[:TRAIN_STEPS])
                              - np.asarray(ref_losses))))
    print(f"train small preset [{batch},{seq}] bf16, {TRAIN_STEPS} steps: "
          f"loss {losses[0]:.4f} -> {losses[TRAIN_STEPS - 1]:.4f}, "
          f"launches {launches}, step p50 {p50:.2f} ms, "
          f"{batch * seq / p50 * 1e3:.0f} tokens/s, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'}; "
          "reference attention step p50 "
          f"{np.median(ref_times) * 1e3:.2f} ms, max|loss - reference| "
          f"{gap:.4g}")
    print("train losses " + " ".join(f"{x:.4f}" for x in losses[:TRAIN_STEPS]))
    print("reference losses " + " ".join(f"{x:.4f}" for x in ref_losses))
    if not gap <= TRAIN_BF16_TOL:
        fail(f"bf16 train losses vs reference attention: {gap}")

    # float32 two-layer copy: one step's gradients, kernels vs reference
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    p32 = W.params_from_jax(tree32, cfg32, device=dev, dtype=torch.float32)
    tok32 = torch.tensor(rng.integers(0, cfg.vocab, size=(4, 201)),
                         device=dev)
    _, g_k = W.loss_and_grads(p32, tok32, cfg32, dev)
    _, g_r = W.loss_and_grads(
        p32, tok32, dataclasses.replace(cfg32, attn="reference"), dev)
    grad_err = max(
        ((a - b).abs().max() / b.abs().max()).item()
        for a, b in zip(_flat(g_k), _flat(g_r)))
    print(f"train f32 2-layer [4,200]: max leaf gradient error vs reference "
          f"{grad_err:.3g} (relative to the leaf's largest)")
    if not grad_err <= TRAIN_GRAD_F32_TOL:
        fail(f"f32 kernel-path gradients vs reference: {grad_err}")
    return launches, dict(
        batch=batch, seq=seq, steps=TRAIN_STEPS, loss_first=losses[0],
        loss_last=losses[TRAIN_STEPS - 1], step_ms_p50=p50,
        step_ms_mean=float(step_ms.mean()),
        tokens_per_s=batch * seq / p50 * 1e3, device_busy_share=busy,
        reference_step_ms_p50=float(np.median(ref_times) * 1e3),
        max_abs_loss_gap_vs_reference=gap, f32_grad_rel_err=grad_err,
        launches=launches,
    )


def _zipf_tokens(rng, vocab: int, n: int, a: float = 1.1):
    """n tokens with a Zipf(a) unigram law over a random permutation of
    the vocabulary: text-like frequencies, so that losses fall."""
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return rng.permutation(vocab)[rng.choice(vocab, size=n, p=p / p.sum())]


# env the runner reads; the runtime phase sets it per run and restores it
RUNTIME_ENV = ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
               "ELASTIC_TPU_HBM_FRACTION", "ELASTIC_TPU_ENV_FILE",
               "ELASTIC_TPU_RESTORE_WAIT_S", "ELASTIC_TPU_RESTORE_DIR",
               "ELASTIC_TPU_RESTORE_STEP", "ELASTIC_TPU_FLIGHT_RECORDER",
               "ELASTIC_TPU_TRACE_ID")


def _runner(R, argv: str, dev) -> dict:
    """runner.main(argv) in this process; the report is its printed last
    line, which is echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main(argv.split(), device=dev)
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"runner {argv}: {line}")
    if rc != 0:
        fail(f"runner {argv}: exit {rc}")
    return json.loads(line)


def run_runtime(torch, A, dev, tmp) -> dict:
    """Phase 6: the runner's train and decode modes, resume, and the
    pre-copy drain, in this process on the card (``tmp`` holds the data
    file and checkpoints; each checkpoint directory goes when its checks
    are done)."""
    import shutil

    from elastic_tpu_agent_torch.workloads import checkpointing as C
    from elastic_tpu_agent_torch.workloads import data as D
    from elastic_tpu_agent_torch.workloads import lifecycle as L
    from elastic_tpu_agent_torch.workloads import runner as R
    from elastic_tpu_agent_torch.workloads import telemetry as T

    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)
    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(tmp, "no-env-file")
    out = {}
    try:
        data = os.path.join(tmp, "tokens.bin")
        D.write_token_file(data, _zipf_tokens(
            np.random.default_rng(SEED + 9), SMALL["vocab"], 1 << 20))
        base = f"--preset small --batch 8 --seq 256 --data {data}"

        # train: 20 steps, evals at steps 9 and 19, saves at 9 and 19
        a = os.path.join(tmp, "a")
        fr = os.path.join(tmp, "fr.jsonl")
        for kern in kerns:
            kern.launches = 0
        rep = _runner(R, f"{base} --steps {RUNTIME_STEPS} --warmup-steps 5 "
                      f"--total-steps {RUNTIME_STEPS} --eval-every 10 "
                      f"--eval-batches {EVAL_BATCHES} --checkpoint-dir {a} "
                      f"--checkpoint-every 10 --flight-recorder {fr}", dev)
        torch.cuda.synchronize()
        launches = {k.symbol: k.launches for k in kerns}
        n_layers = SMALL["n_layers"]
        # one forward and backward of the warm-up, then the steps and the
        # two evals
        want = {"flash_fwd": n_layers * (1 + RUNTIME_STEPS + 2 * EVAL_BATCHES),
                "flash_bwd_dkdv": n_layers * (1 + RUNTIME_STEPS),
                "flash_bwd_dq": n_layers * (1 + RUNTIME_STEPS)}
        if launches != want:
            fail(f"runner train launches {launches}, want {want}")
        ev = [e["loss"] for e in rep.get("eval", [])]
        recs = T.load_jsonl(fr)
        steps = [r for r in recs if r["kind"] == "step"]
        saves = [r["duration_ms"] for r in recs
                 if r["kind"] == "checkpoint_save"]
        print(f"runtime train: step_time_ms {rep['step_time_ms']:.2f} with "
              f"checkpoint saves of {saves} ms in the window; step records "
              + ", ".join(f"{r['duration_ms']:.1f}" for r in steps) + " ms")
        if rep["steps"] != RUNTIME_STEPS or rep["platform"] != "gpu":
            fail(f"runner train: {rep['steps']} steps on {rep['platform']}")
        if not np.isfinite(rep["final_loss"] or np.nan):
            fail(f"runner train final loss {rep['final_loss']}")
        if len(ev) != 2 or not ev[1] < ev[0]:
            fail(f"runner eval losses {ev}: not two, falling")
        if len(steps) != RUNTIME_STEPS:
            fail(f"flight recorder: {len(steps)} step records")
        mem = steps[-1].get("device_memory") if steps else None
        out["train"] = dict(
            steps=rep["steps"], step_time_ms=rep["step_time_ms"],
            tokens_per_s=rep["tokens_per_s"], final_loss=rep["final_loss"],
            eval_losses=ev, launches=launches, checkpoint_save_ms=saves,
            flight_mean_step_ms=rep["flight_recorder"].get("mean_step_ms"),
            step_ms=[r["duration_ms"] for r in steps], device_memory=mem,
        )

        # decode from that checkpoint (generate's cached attention: no
        # hand-written kernel on this path)
        for kern in kerns:
            kern.launches = 0
        dec = _runner(R, f"--mode decode --preset small --batch 8 "
                      f"--prompt-len 32 --new-tokens 64 --checkpoint-dir {a}",
                      dev)
        if dec["restored_step"] != RUNTIME_STEPS - 1:
            fail(f"decode restored step {dec['restored_step']}")
        if dec["decode_tokens_per_s"] is None:
            fail("decode_tokens_per_s is null")
        out["decode"] = {k: dec[k] for k in (
            "restored_step", "prefill_ms", "decode_tokens_per_s",
            "ms_per_token", "end_to_end_s")}
        out["decode"]["launches"] = {k.symbol: k.launches for k in kerns}
        shutil.rmtree(a)

        # resume: 10 steps, then the same command resumes at step 10
        b = os.path.join(tmp, "b")
        cmd = (f"{base} --steps 10 --warmup-steps 5 --total-steps "
               f"{RUNTIME_STEPS} --checkpoint-dir {b} --checkpoint-every 10")
        first = _runner(R, cmd, dev)
        second = _runner(R, cmd, dev)
        gap = abs(second["final_loss"] - rep["final_loss"])
        print(f"runtime resume: start_step {first['start_step']} then "
              f"{second['start_step']}, final loss {second['final_loss']:.6f}"
              f" vs uninterrupted {rep['final_loss']:.6f}: gap {gap:.3g} "
              f"(limit {RESUME_TOL})")
        if (first["start_step"], second["start_step"]) != (0, 10):
            fail(f"resume start steps {first['start_step']}, "
                 f"{second['start_step']}")
        if not gap <= RESUME_TOL:
            fail(f"resumed final loss off the uninterrupted run by {gap}")
        out["resume"] = dict(start_step=second["start_step"],
                             final_loss=second["final_loss"], gap=gap,
                             step_time_ms=second["step_time_ms"])
        shutil.rmtree(b)

        # pre-copy drain: the spec carries the drain stamp from the start
        alloc, h = os.path.join(tmp, "alloc"), "chipsmoke0"
        os.makedirs(alloc)
        with open(os.path.join(alloc, f"{h}.json"), "w") as f:
            json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke",
                               "ELASTIC_TPU_DRAIN_DEADLINE":
                               str(time.time() + 3600)}}, f)
        os.environ.update(TPU=h, ELASTIC_TPU_ALLOC_DIR=alloc,
                          ELASTIC_TPU_RESTORE_WAIT_S="0")
        c = os.path.join(tmp, "c")
        fr_c = os.path.join(tmp, "fr_c.jsonl")
        pre = _runner(R, f"{base} --steps 10 --precopy-every 5 "
                      f"--checkpoint-every 0 --checkpoint-dir {c} "
                      f"--flight-recorder {fr_c}", dev)
        ack = L.read_checkpoint_ack(alloc, h) or {}
        chain = C.DeltaCheckpointer(c).verify()
        rounds = [r for r in T.load_jsonl(fr_c)
                  if r["kind"] in ("precopy_round", "cutover")]
        print("runtime pre-copy: " + "; ".join(
            f"{r['kind']} {r['round']} at step {r['step']}: "
            f"{r['delta_bytes']} of {r['total_bytes']} bytes in "
            f"{r['duration_ms']:.1f} ms (copy to the host "
            f"{r['copy_ms']:.1f})" for r in rounds)
            + f"; ack cutover_ms {ack.get('cutover_ms')}; step_time_ms "
            f"{pre['step_time_ms']:.2f}")
        if pre["precopy_rounds"] < 1 or ack.get("precopy_rounds") is None:
            fail(f"pre-copy rounds {pre['precopy_rounds']}, ack {ack}")
        if not (chain["ok"] and ack.get("digest") == chain["chain"]
                and ack.get("kind") == "checkpoint"):
            fail(f"pre-copy ack {ack} vs verified chain {chain}")
        for k in ("TPU", "ELASTIC_TPU_ALLOC_DIR"):
            os.environ.pop(k)
        back = _runner(R, f"{base} --steps 1 --checkpoint-every 0 "
                       f"--checkpoint-dir {c}", dev)
        if back["start_step"] != 10:
            fail(f"resume from the delta chain at {back['start_step']}")
        out["precopy"] = dict(
            rounds=pre["precopy_rounds"], payload_bytes=chain["total_bytes"],
            round_log=rounds, cutover_ms=ack.get("cutover_ms"),
            final_delta_bytes=ack.get("delta_bytes"),
            resumed_start_step=back["start_step"],
            step_time_ms=pre["step_time_ms"],
        )
        shutil.rmtree(c)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def moe_onehot(torch, x, params, factor):
    """The JAX MoE layer's one-hot einsum form
    (elastic_tpu_agent/workloads/moe.py:160-207) in torch: the plain
    version ``moe_mlp`` is held against. Returns (y, aux, expert, kept)."""
    F = torch.nn.functional
    b, s, d = x.shape
    n_exp = params["wg"].shape[1]
    dtype = x.dtype
    xt = x.reshape(b * s, d)
    cap = max(1, math.ceil(b * s * factor / n_exp))
    probs = torch.softmax(xt.float() @ params["wg"].float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    mask = F.one_hot(expert, n_exp).float()
    aux = n_exp * torch.sum(mask.mean(0) * probs.mean(0))
    imask = mask.to(torch.int32)
    position = torch.cumsum(imask, dim=0) * imask
    imask = imask * (position <= cap)
    mask = imask.float()
    gate = torch.sum(probs * mask, dim=-1)
    slot = torch.sum((position - 1) * imask, dim=-1)
    dispatch = mask[:, :, None] * F.one_hot(slot, cap).float()[:, None, :]
    combine = (dispatch * gate[:, None, None]).to(dtype)
    dispatch = dispatch.to(dtype)
    xin = torch.einsum("tec,td->ecd", dispatch, xt)
    h = F.gelu(torch.einsum("ecd,edf->ecf", xin, params["w1"].to(dtype)),
               approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, params["w2"].to(dtype))
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.reshape(b, s, d), aux, expert, imask.sum(-1) > 0


def check_moe_layer(torch, M, layer, dev):
    """moe_mlp against its one-hot einsum form at the MoE cell's layer
    shape (8 x 256 tokens, d 512, ff 2048, 4 experts), on the bridged
    weights of the preset's first MoE layer: float32 outputs, aux loss,
    routes and gradients of sum(y * r) + aux, at the cell's factor 1.25
    and at 1.0, where some expert must overflow (so that drops are
    checked); bf16 outputs at 1.25."""
    rng = np.random.default_rng(SEED + 10)
    d = layer["wg"].shape[0]
    out = {}
    for name, factor in (("float32", 1.25), ("float32", 1.0),
                         ("bfloat16", 1.25)):
        dtype = getattr(torch, name)
        x = randn(torch, rng, (8, 256, d), dtype, dev)
        r = randn(torch, rng, (8, 256, d), dtype, dev)
        params = {k: v.detach().float().clone() for k, v in layer.items()}
        leaves = [x] + [params[k] for k in ("wg", "w1", "w2")]
        for t in leaves:
            t.requires_grad_(name == "float32")
        with torch.enable_grad():
            y, aux = M.moe_mlp(x, params, factor)
            y_ref, aux_ref, expert_ref, kept_ref = moe_onehot(
                torch, x, params, factor)
            _, expert, _, kept, _ = M.route(
                x.detach().reshape(-1, d), params["wg"], factor)
            errs = {
                "y": ((y.float() - y_ref.float()).abs().max()
                      / y_ref.float().abs().max()).item(),
                "aux": abs(aux.item() - aux_ref.item()) / aux_ref.item(),
            }
            if name == "float32":
                g = torch.autograd.grad((y * r).sum() + aux, leaves)
                g_ref = torch.autograd.grad(
                    (y_ref * r).sum() + aux_ref, leaves)
                for k, a, b in zip(("dx", "dwg", "dw1", "dw2"), g, g_ref):
                    errs[k] = ((a - b).abs().max() / b.abs().max()).item()
        routes = int((expert != expert_ref).sum().item()
                     + (kept != kept_ref).sum().item())
        dropped = int((~kept_ref).sum().item())
        label = f"moe layer {name} factor {factor}"
        print(f"{label} [8,256,{d}] E{MOE_EXPERTS} vs one-hot einsum form: "
              "relative max err "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; routes differing {routes}; dropped {dropped} of 2048")
        if routes or max(errs.values()) > MOE_LAYER_TOL[name]:
            fail(f"{label}: errors {errs}, routes differing {routes}")
        if factor == 1.0 and not dropped:
            fail(f"{label}: no token dropped, the capacity went unchecked")
        out[f"{name} factor {factor}"] = dict(
            errors=errs, routes_differing=routes, dropped=dropped)
    return out


class RouteLog:
    """While active, records each ``moe.route`` call's inputs and
    decisions (read-only instrumentation: the call's results are
    returned unchanged)."""

    def __init__(self, M):
        self.M = M
        self.calls = []

    def __enter__(self):
        self.real = real = self.M.route

        def logged(xt, wg, factor):
            res = real(xt, wg, factor)
            self.calls.append(dict(xt=xt.detach(), wg=wg.detach(),
                                   factor=factor, expert=res[1], kept=res[3]))
            return res

        self.M.route = logged
        return self

    def __exit__(self, *exc):
        self.M.route = self.real


def routes_differing(a: "RouteLog", b: "RouteLog") -> int:
    return sum(int((x["expert"] != y["expert"]).sum().item())
               for x, y in zip(a.calls, b.calls))


def routing_stats(M, log: "RouteLog", aux=None) -> dict:
    st = M.MoeRoutingStats()
    for c in log.calls:
        st.observe(c["xt"], {"wg": c["wg"]}, c["factor"])
    out = st.stats()
    out["aux_loss"] = aux
    return out


def run_moe(torch, W, A, PA, M, tree, dev):
    """The MoE cell: the layer against its one-hot form, the forward, 20
    train steps, 16 requests on the kernel-path engine and a float32
    two-layer copy. Each path's kernel counts are set to 0 just before it
    and read just after."""
    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16,
                        moe_experts=MOE_EXPERTS)
    n_params = sum(int(np.prod(x.shape)) for x in _flat(tree))
    params = W.params_from_jax(tree, cfg, device=dev)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    out = dict(params=n_params, moe_layers=moe_layers,
               layer=check_moe_layer(torch, M, params["layers"][
                   moe_layers[0]]["moe"], dev))
    kerns = (A.FLASH_FWD, A.FLASH_BWD_DKDV, A.FLASH_BWD_DQ)

    # forward [8, 256] through the flash kernel vs reference attention
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    A.FLASH_FWD.launches = 0
    with RouteLog(M) as got_log:
        logits, aux = W.forward_with_aux(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_launches = A.FLASH_FWD.launches
    ref_cfg = dataclasses.replace(cfg, attn="reference")
    with RouteLog(M) as ref_log:
        ref = W.forward(params, tokens, ref_cfg, device=dev)
    d = (logits.float() - ref.float()).abs()
    flips = routes_differing(got_log, ref_log)
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    for _ in range(3):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        W.forward(params, tokens, cfg, device=dev)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"moe forward small preset E{MOE_EXPERTS} [8,256] bf16 "
          f"({n_params} params): flash_fwd launches {fwd_launches}, "
          f"{fwd_ms:.2f} ms, aux {aux.item():.4f}; vs reference attention: "
          f"max|logits diff| {d.max().item():.3g}, mean {d.mean().item():.3g}"
          f", argmax agreement {agree:.4f}, routes differing {flips} of "
          f"{len(moe_layers) * 2048}")
    if fwd_launches != cfg.n_layers:
        fail(f"moe forward launched flash_fwd {fwd_launches}x")
    if tuple(logits.shape) != (8, 256, cfg.vocab) or not torch.isfinite(
            logits).all():
        fail(f"moe forward logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    if not d.mean().item() <= MOE_FORWARD_BF16_MEAN_TOL:
        fail(f"moe forward logits vs reference: mean {d.mean().item()}")
    out["forward"] = dict(ms=fwd_ms, flash_launches=fwd_launches,
                          aux=aux.item(), max_abs_err=d.max().item(),
                          mean_abs_err=d.mean().item(), argmax_agreement=agree,
                          routes_differing=flips)

    # 20 train steps at [8, 256]
    rng = np.random.default_rng(SEED + 12)
    batch = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 257)),
                         device=dev)
    for kern in kerns:
        kern.launches = 0
    losses, times, _ = _train(torch, W, cfg, tree, dev, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kerns}
    want = cfg.n_layers * TRAIN_STEPS
    if any(n != want for n in launches.values()):
        fail(f"moe train launches {launches}, want {want} each")
    if not all(np.isfinite(losses)) or not losses[-1] < 0.9 * losses[0]:
        fail(f"moe train losses {losses[0]} -> {losses[-1]}")
    ref_losses, ref_times, _ = _train(torch, W, ref_cfg, tree, dev, batch,
                                      TRAIN_STEPS)
    gaps = np.abs(np.asarray(losses) - np.asarray(ref_losses))
    gap = float(gaps.max())
    p50 = float(np.median(times) * 1e3)
    p32 = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    with torch.no_grad(), RouteLog(M) as log0:
        aux0 = W.forward_with_aux(p32, batch[:, :-1], cfg, dev)[1].item()
    stats0 = routing_stats(M, log0, aux0)
    print(f"moe train small preset [8,256] bf16, {TRAIN_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches}, step "
          f"p50 {p50:.2f} ms ({8 * 256 / p50 * 1e3:.0f} tokens/s); reference"
          f" attention step p50 {np.median(ref_times) * 1e3:.2f} ms, "
          f"max|loss - reference| {gap:.4g} (steps 0-9 "
          f"{gaps[:10].max():.4g}, mean {gaps.mean():.4g}); at step 0: aux "
          f"{aux0:.4f}, "
          f"drop rate {stats0['drop_rate']}, imbalance "
          f"{stats0['imbalance']}, expert load {stats0['expert_load']}")
    print("moe train losses " + " ".join(f"{x:.4f}" for x in losses))
    print("moe reference losses " + " ".join(f"{x:.4f}" for x in ref_losses))
    if not gap <= MOE_TRAIN_BF16_TOL:
        fail(f"moe bf16 train losses vs reference attention: {gap}")
    out["train"] = dict(steps=TRAIN_STEPS, loss_first=losses[0],
                        loss_last=losses[-1], step_ms_p50=p50,
                        tokens_per_s=8 * 256 / p50 * 1e3,
                        reference_step_ms_p50=float(
                            np.median(ref_times) * 1e3),
                        max_abs_loss_gap_vs_reference=gap,
                        mean_abs_loss_gap=float(gaps.mean()),
                        max_abs_loss_gap_first10=float(gaps[:10].max()),
                        launches=launches,
                        routing_step0=stats0)
    del p32

    # 16 requests on the kernel-path engine
    n_req, new_tokens = 16, 64
    prompts, kinds = _serving_requests(cfg, SEED + 4)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev)
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged = PA.PAGED_DECODE.launches
    steps = eng.decode_steps_total
    if paged == 0 or paged != cfg.n_layers * steps:
        fail(f"moe serving: paged_decode launched {paged}x over {steps} "
             "decode steps")
    if any(len(x) != new_tokens for x in streams) or eng.used_blocks:
        fail("moe serving streams or pool blocks")
    print(f"moe serving small preset: {n_req} requests x {new_tokens} "
          f"tokens, {steps} decode steps, paged_decode launches {paged}, "
          f"{n_req * new_tokens / wall:.1f} tokens/s")
    out["serving"] = dict(requests=n_req, new_tokens=new_tokens,
                          decode_steps=steps, paged_launches=paged,
                          tokens_per_s=n_req * new_tokens / wall)
    out["launches"] = dict(launches, flash_fwd_forward=fwd_launches,
                           paged_decode=paged)
    del eng, params

    # float32 two-layer copy (layer 1 is MoE): streams and gradients. The
    # engine's prefill routes a bucket-padded row, or a block-sized chunk,
    # with the training factor, as the JAX engine does, so where a prompt
    # drops tokens there its stream may leave generate()'s (whose prefill
    # routes the bare prompt): at factor 1.25 the two engine paths must
    # agree, and generate() must agree with both at the drop-free factor E
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    tree32 = dict(tree, layers=tree["layers"][:2])
    params32 = W.params_from_jax(tree32, cfg32, device=dev)
    few = [p[:40] for p in prompts[:8]]
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    same, agree_125 = True, None
    for factor in (cfg.moe_capacity_factor, float(MOE_EXPERTS)):
        c = dataclasses.replace(cfg32, moe_capacity_factor=factor)
        runs = {}
        for paged_path in (True, False):
            e = W.ServingEngine(params32, c, slots=8, max_len=512,
                                prompt_buckets=(16, 64, 256),
                                paged_kernel=paged_path, device=dev)
            runs[paged_path] = serve(W, e, few, greedy, 32)
        oracle = [W.generate(params32, [p], c, 32, device=dev)[0, len(p):]
                  .tolist() for p in few]
        if factor == cfg.moe_capacity_factor:
            same &= runs[True] == runs[False]
            agree_125 = sum(a == b for a, b in zip(runs[False], oracle))
        else:
            same &= runs[True] == runs[False] == oracle
    tok32 = torch.tensor(rng.integers(0, cfg.vocab, size=(4, 201)),
                         device=dev)
    with RouteLog(M) as k_log:
        _, g_k = W.loss_and_grads(params32, tok32, cfg32, dev)
    with RouteLog(M) as r_log:
        _, g_r = W.loss_and_grads(
            params32, tok32, dataclasses.replace(cfg32, attn="reference"),
            dev)
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(_flat(g_k), _flat(g_r)))
    flips32 = routes_differing(k_log, r_log)
    print(f"moe f32 2-layer: kernel path == gather path (factor 1.25, and "
          f"== generate() at the drop-free factor {MOE_EXPERTS}): {same} "
          f"({agree_125} of 8 streams equal generate()'s at 1.25); "
          "gradients [4,200] max leaf error vs reference "
          f"{grad_err:.3g} (relative to the leaf's largest), routes "
          f"differing {flips32} of 800")
    if not same:
        fail("moe f32 kernel-path streams differ from gather path / "
             "generate()")
    if not grad_err <= MOE_GRAD_F32_TOL:
        fail(f"moe f32 kernel-path gradients vs reference: {grad_err}")
    out["f32"] = dict(streams_equal=same, grad_rel_err=grad_err,
                      routes_differing=flips32,
                      generate_agreement_at_factor_1_25=agree_125)
    return out


def _bytes_of(Q, tree) -> dict:
    """{path: bytes} over an int8 tree's arrays, copied to the host."""
    out = {}

    def add(path, leaf):
        for k, t in (leaf.items() if Q.is_quantized(leaf) else [("", leaf)]):
            out[(*path, k)] = t.cpu().numpy().tobytes()

    Q._tree_map(add, tree)
    return out


def run_int8(torch, W, PA, Q, R, cfg, tree, params, dev):
    """int8 at the dense preset: the quantized tree on the card against
    the CPU's, generate on int8 weights, a kv_int8 engine, runner --int8."""
    p32 = W.params_from_jax(tree, cfg, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = Q.quantize_params(p32)
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    del p32
    q_cpu = Q.quantize_params(
        W.params_from_jax(tree, cfg, device="cpu", dtype=torch.float32))
    got, want = _bytes_of(Q, q), _bytes_of(Q, q_cpu)
    differ = sorted(k for k in want if got.get(k) != want[k])
    same = got.keys() == want.keys() and not differ
    nbytes = Q.quantized_bytes(q)
    print(f"int8 quantize_params on the card: {q_ms:.1f} ms, byte-equal to "
          f"the CPU's: {same} ({len(want)} arrays, differing {differ[:6]}); "
          f"{nbytes} bytes stored vs {Q.quantized_bytes(params)} in bf16")
    if not same:
        fail(f"int8 tree on the card differs from the CPU's: {differ}")
    del q_cpu

    rng = np.random.default_rng(SEED + 13)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 32)),
                          device=dev)
    rates, toks = {}, {}
    for name, p in (("int8", q), ("bf16", params)):
        W.generate(p, prompt, cfg, 64, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[name] = W.generate(p, prompt, cfg, 64, device=dev)[:, 32:]
        torch.cuda.synchronize()
        rates[name] = 8 * 64 / (time.perf_counter() - t0)
    agree = (toks["int8"] == toks["bf16"]).float().mean().item()
    print(f"int8 generate [8, 32 + 64] greedy: {rates['int8']:.1f} tokens/s "
          f"(bf16 weights {rates['bf16']:.1f}); greedy tokens agreeing with "
          f"the bf16 stream {agree:.4f}")
    if not bool(((toks["int8"] >= 0) & (toks["int8"] < cfg.vocab)).all()):
        fail("int8 generate tokens out of range")
    del q

    prompts, kinds = _serving_requests(cfg, SEED + 4)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), kv_int8=True,
                          device=dev)
    PA.PAGED_DECODE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = serve(W, eng, prompts, kinds, 64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paged = PA.PAGED_DECODE.launches
    print(f"kv_int8 serving small preset: 16 requests x 64 tokens, "
          f"paged_kernel {eng.paged_kernel}, paged_decode launches {paged}, "
          f"{16 * 64 / wall:.1f} tokens/s")
    if paged or eng.paged_kernel or not eng.stats()["kv_int8"]:
        fail(f"kv_int8 engine: paged_kernel {eng.paged_kernel}, launches "
             f"{paged}")
    if any(len(x) != 64 for x in streams) or eng.used_blocks:
        fail("kv_int8 serving streams or pool blocks")
    del eng

    saved = {k: os.environ.pop(k, None) for k in RUNTIME_ENV}
    os.environ["ELASTIC_TPU_ENV_FILE"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "no-env-file")
    try:
        rep = _runner(R, "--mode decode --preset small --batch 8 "
                      "--prompt-len 32 --new-tokens 64 --int8", dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rep.get("int8") is not True or rep.get("decode_tokens_per_s") is None:
        fail(f"runner --int8 report {rep}")
    return dict(quantize_ms=q_ms, byte_equal=same, stored_bytes=nbytes,
                generate_tokens_per_s=rates, greedy_agreement=agree,
                kv_int8_tokens_per_s=16 * 64 / wall,
                kv_int8_paged_launches=paged,
                runner={k: rep.get(k) for k in (
                    "int8", "prefill_ms", "decode_tokens_per_s",
                    "ms_per_token", "sample_tail")})


def run_drain(torch, W, L, T, cfg, params, dev, tmp):
    """The engine's recorder and lifecycle: 16 admitted requests on the
    kernel-path engine with a FlightRecorder and a LifecycleWatcher over
    an alloc spec; then a drain stamped into the spec."""
    alloc, h = os.path.join(tmp, "alloc_serving"), "chipsmokesrv"
    os.makedirs(alloc)
    spec = os.path.join(alloc, f"{h}.json")
    with open(spec, "w") as f:
        json.dump({"env": {}}, f)
    watcher = L.LifecycleWatcher(alloc, h, poll_interval_s=0.0)
    rec = T.FlightRecorder(path="", trace_id="")
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), recorder=rec,
                          lifecycle=watcher, device=dev)
    prompts, kinds = _serving_requests(cfg, SEED + 14)
    kinds = [(True, kw) for _, kw in kinds]       # every request admitted
    step_times = []
    serve(W, eng, prompts, kinds, 32, step_times)
    kinds_ = [r["kind"] for r in rec.records]
    admits = kinds_.count("serving_admit")
    steps = kinds_.count("serving_step")
    print(f"recorder: {admits} serving_admit records for 16 admissions, "
          f"{steps} serving_step records for {len(step_times)} steps")
    if admits != 16 or steps != len(step_times):
        fail(f"recorder: {admits} admit and {steps} step records")

    live = [eng.admit(p[:50]) for p in prompts[:4]]
    for _ in range(3):
        eng.step()
    with open(spec, "w") as f:
        json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke"}}, f)
    refused = []
    for fn in (eng.admit, eng.enqueue):
        try:
            fn(prompts[5][:20])
        except ValueError:
            refused.append(fn.__name__)
    summary = L.drain_serving(eng, watcher)
    ack = L.read_checkpoint_ack(alloc, h) or {}
    finished = [eng.finish_reason.get(r) for r in live]
    print(f"drain: admission refused by {refused}; drain_serving {summary}; "
          f"finish reasons {finished}; ack kind {ack.get('kind')}")
    if refused != ["admit", "enqueue"]:
        fail(f"drain: refused {refused}")
    if summary["live_requests"] or None in finished or ack.get(
            "kind") != "drained":
        fail(f"drain: summary {summary}, finished {finished}, ack {ack}")
    return dict(admit_records=admits, step_records=steps,
                steps=len(step_times), refused=refused,
                drain_steps=summary["steps"],
                drained_tokens=summary["drained_tokens"],
                ack_kind=ack.get("kind"))


SYSTEM_TOKENS = 128          # the prefix cell's shared system prompt


def _prefix_requests(cfg, seed, n=16):
    """The prefix cell's requests: one 128-token system prompt (8 full
    blocks at block 16) followed by user tails of 8-64 tokens, drawn with
    numpy from ``seed``; half admitted and half enqueued, half greedy and
    half sampled, the SLO classes in turn. Returns (system, prompts,
    kinds, slos)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, size=SYSTEM_TOKENS).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, size=int(t)).tolist()
               for t in rng.integers(8, 65, size=n)]
    kinds = [(i % 4 < 2, {} if i % 2 == 0 else dict(temperature=0.8,
                                                     top_k=50))
             for i in range(n)]
    slos = [("ttft", "tpot", "batch")[i % 3] for i in range(n)]
    return system, prompts, kinds, slos


def _index_of(prompts, tokens) -> int:
    """The request whose prompt the handoff record's tokens start with."""
    tokens = [int(t) for t in tokens]
    return next(i for i, p in enumerate(prompts) if tokens[:len(p)] == p)


def serve_disaggregated(pre, dec, prompts, kinds, slos, new_tokens):
    """The prompts through a prefill-role engine, each handed to the
    decode-role engine by its cache hit as soon as its prefill lands;
    decode runs every tick. One publication is pending at a time: a
    cache-hit admission of either role adopts whichever record was
    published last under its covered chain's last digest, so with two
    pending, requests that share the system prompt would pair wrongly
    (the JAX engine's rule, pinned by tests/test_torch_disagg.py).
    Returns the streams and each decode admission's prefilled tokens."""
    queue = list(range(len(prompts)))
    at_pre, at_dec, streams, tail = {}, {}, {}, {}

    def hand_over():
        for rid, i in list(at_pre.items()):
            if pre.finish_reason.get(rid) == "prefilled":
                pre.release(rid)
                del at_pre[rid]
                before = dec.prefilled_tokens_total
                at_dec[dec.admit(prompts[i], **kinds[i][1])] = i
                tail[i] = dec.prefilled_tokens_total - before

    while queue or at_pre or at_dec:
        while (queue and len(at_pre) < pre.slots
               and len(at_pre) + len(at_dec) < dec.slots):
            i = queue.pop(0)
            fn = pre.admit if kinds[i][0] else pre.enqueue
            at_pre[fn(prompts[i], slo=slos[i])] = i
            hand_over()
        pre.step()
        hand_over()
        dec.step()
        for rid, i in list(at_dec.items()):
            if rid in dec.finish_reason or len(dec.stream(rid)) >= new_tokens:
                streams[i] = dec.release(rid)
                del at_dec[rid]
    return [streams[i] for i in range(len(prompts))], tail


def serve_handed_off(L, src, peer, prompts, kinds, new_tokens, steps,
                     watcher=None):
    """Open the prompts on ``src`` (admit or enqueue), decode ``steps``
    steps, then ``drain_serving(handoff=True)``: every open stream is
    published through the shared pool; ``peer`` adopts each record and
    decodes it to ``new_tokens``. Returns the streams and the drain's
    summary."""
    for i, p in enumerate(prompts):
        (src.admit if kinds[i][0] else src.enqueue)(p, **kinds[i][1])
    for _ in range(steps):
        src.step()
    summary = L.drain_serving(src, watcher, handoff=True)
    pool, rid_of = src.shared_pool, {}
    while True:
        rec = pool.claim_stream()
        if rec is None:
            break
        rid_of[peer.adopt_stream(rec)] = _index_of(prompts, rec["tokens"])
    streams = {}
    while rid_of:
        peer.step()
        for rid, i in list(rid_of.items()):
            if (rid in peer.finish_reason
                    or len(peer.stream(rid)) >= new_tokens):
                streams[i] = peer.release(rid)
                del rid_of[rid]
    return [streams.get(i) for i in range(len(prompts))], summary


def _leak_check(label, used, cached, cache):
    """After every release a pool holds only its prefix cache's blocks,
    and nothing after the cache is cleared."""
    cache.clear()
    print(f"{label}: used_blocks {used} == cached blocks {cached}; after "
          f"clear() {cache._alloc.used}")
    if used != cached or cache._alloc.used != 0:
        fail(f"{label}: used {used}, cached {cached}, after clear "
             f"{cache._alloc.used}")


def run_prefix(torch, W, PA, L, RO, cfg, params, tree, dev, tmp):
    """The prefix cache, the shared pool with prefill/decode roles, the
    mid-stream handoff drain and the request observatory at the small
    preset (bf16), then token-exact checks on a float32 two-layer copy."""
    new_tokens = 64
    system, prompts, kinds, slos = _prefix_requests(cfg, SEED + 15)
    eng_kw = dict(slots=8, max_len=512, prompt_buckets=(16, 64, 256),
                  device=dev)
    out = {}
    # prefix cell: the same 16 requests without and with the cache, on
    # the kernel path
    for cached in (False, True):
        eng = W.ServingEngine(params, cfg, prefix_cache=cached, **eng_kw)
        if not eng.paged_kernel:
            fail("prefix cell: paged_kernel auto did not resolve ON")
        ttft = {}
        PA.PAGED_DECODE.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = serve(W, eng, prompts, kinds, new_tokens, ttft=ttft)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = PA.PAGED_DECODE.launches
        steps = eng.decode_steps_total
        if launches != cfg.n_layers * steps or steps == 0:
            fail(f"prefix cell: paged_decode launched {launches}x over "
                 f"{steps} decode steps")
        if any(len(x) != new_tokens for x in streams):
            fail("prefix cell: a stream is short")
        st = eng.stats()
        pc = st.get("prefix_cache", {})
        rec = dict(prefilled_tokens_total=st["prefilled_tokens_total"],
                   admitted_tokens_total=st["admitted_tokens_total"],
                   hits=pc.get("hits"), misses=pc.get("misses"),
                   hit_tokens=pc.get("hit_tokens"), decode_steps=steps,
                   paged_launches=launches, wall_s=wall,
                   tokens_per_s=16 * new_tokens / wall,
                   ttft_p50_ms=float(np.median(list(ttft.values()))) * 1e3,
                   ttft_p90_ms=float(np.percentile(list(ttft.values()), 90))
                   * 1e3)
        print(f"prefix cell cache={cached}: prefilled "
              f"{rec['prefilled_tokens_total']} of "
              f"{rec['admitted_tokens_total']} tokens, hits {rec['hits']},"
              f" misses {rec['misses']}, TTFT p50 {rec['ttft_p50_ms']:.2f} ms"
              f" (p90 {rec['ttft_p90_ms']:.2f}), {rec['tokens_per_s']:.1f} "
              f"tokens/s, {steps} decode steps, paged_decode launches "
              f"{launches}")
        out["cached" if cached else "uncached"] = rec
    if not (out["cached"]["prefilled_tokens_total"]
            < out["uncached"]["prefilled_tokens_total"]):
        fail("prefix cell: the cache did not cut prefilled tokens")
    cache = eng._prefix_cache
    used, cached_blocks = eng.used_blocks, cache.cached_blocks
    # explicit prefix on the same engine: register the system prompt and
    # admit 8 tails with prefix=
    pid = eng.register_prefix(system)
    tails = [p[SYSTEM_TOKENS:] for p in prompts[:8]]
    PA.PAGED_DECODE.launches = 0
    steps0 = eng.decode_steps_total
    explicit = serve(W, eng, tails,
                     [(True, dict(kw, prefix=pid)) for _, kw in kinds[:8]],
                     new_tokens)
    launches = PA.PAGED_DECODE.launches
    if launches != cfg.n_layers * (eng.decode_steps_total - steps0):
        fail(f"explicit prefix: {launches} paged_decode launches")
    if any(len(x) != new_tokens for x in explicit):
        fail("explicit prefix: a stream is short")
    eng.release_prefix(pid)
    print(f"explicit prefix: 8 admissions on the registered system prompt, "
          f"paged_decode launches {launches}")
    out["explicit"] = dict(requests=8, paged_launches=launches)
    if eng.used_blocks != cache.cached_blocks:
        fail(f"explicit prefix: {eng.used_blocks} blocks held, cache "
             f"{cache.cached_blocks}")
    _leak_check("prefix cell", used, cached_blocks, cache)
    del eng, cache

    # disaggregated pair over one SharedKVPool (the gather path), with one
    # observatory shared by both roles
    def pair(cfg_, params_, obs=None, handoff=False):
        """Two engines over one pool: prefill (4 slots) and decode (8),
        or for a handoff two decode-role engines of 8 slots."""
        pool = W.SharedKVPool(cfg_, block_size=16,
                              pool_blocks=1 + (8 + 8 + 2) * 32, device=dev)
        kw = dict(eng_kw, pool=pool, observatory=obs)
        first = (dict(kw, role="decode") if handoff
                 else dict(kw, role="prefill", slots=4))
        return (pool, W.ServingEngine(params_, cfg_, **first),
                W.ServingEngine(params_, cfg_, role="decode", **kw))

    obs = RO.RequestObservatory()
    pool, pre, dec = pair(cfg, params, obs)
    t0 = time.perf_counter()
    streams, tail = serve_disaggregated(pre, dec, prompts, kinds, slos,
                                        new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ds = W.disaggregated_status(pre, dec)
    adoptions = dec.stats()["adoptions_total"]
    print(f"disaggregated: {len(prompts)} requests, decode adoptions "
          f"{adoptions}, decode-role prefill per request max "
          f"{max(tail.values())} tokens (block 16), prefill role prefilled "
          f"{ds['roles']['prefill']['prefilled_tokens_total']}, "
          f"{16 * new_tokens / wall:.1f} tokens/s")
    if adoptions != 16 or max(tail.values()) > 16 or min(tail.values()) < 1:
        fail(f"disaggregated: adoptions {adoptions}, tails {tail}")
    if any(len(x) != new_tokens for x in streams):
        fail("disaggregated: a stream is short")
    st = obs.status()
    recs = st["requests"]
    worst = max(abs(sum(r["phases_ms"].values()) + r["residual_ms"]
                    - r["wall_ms"]) for r in recs)
    ids = [r["id"] for r in recs]
    print(f"observatory: {st['finished']} finished, {st['stitched']} "
          f"stitched, {len(set(ids))} ids, worst |sum(phases) + residual - "
          f"wall| {worst:.4f} ms, worst residual "
          f"{st['conservation']['worst_residual_ms']} ms")
    for c, v in st["classes"].items():
        print(f"observatory {c}: TTFT p50 {v['ttft_p50_ms']} p99 "
              f"{v['ttft_p99_ms']} ms, TPOT p50 {v['tpot_p50_ms']} p99 "
              f"{v['tpot_p99_ms']} ms, attainment {v['attainment']}")
    if (st["finished"] != 16 or st["stitched"] != 16 or len(ids) != 16
            or len(set(ids)) != 16 or worst > 1.0
            or abs(st["conservation"]["worst_residual_ms"]) > 1.0
            or st["live"] or st["pending_handoff"]):
        fail(f"observatory: {st['finished']} finished, {st['stitched']} "
             f"stitched, ids {ids}, worst {worst}")
    out["disaggregated"] = dict(
        adoptions=adoptions, decode_prefill_max=max(tail.values()),
        prefill_role_prefilled=ds["roles"]["prefill"][
            "prefilled_tokens_total"],
        tokens_per_s=16 * new_tokens / wall,
        observatory={c: {k: v[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                           "tpot_p50_ms", "tpot_p99_ms")}
                     for c, v in st["classes"].items()},
        worst_conservation_ms=worst)
    _leak_check("disaggregated", pool.used_blocks,
                pool.prefix_cache.cached_blocks, pool.prefix_cache)
    del pool, pre, dec

    # mid-stream handoff: 8 live streams, 10 steps, a handoff drain acked
    # through a watcher, a peer finishing them
    alloc, h = os.path.join(tmp, "alloc_handoff"), "chipsmokehandoff"
    os.makedirs(alloc)
    with open(os.path.join(alloc, f"{h}.json"), "w") as f:
        json.dump({"env": {"ELASTIC_TPU_DRAIN": "maintenance:smoke"}}, f)
    watcher = L.LifecycleWatcher(alloc, h, poll_interval_s=0.0)
    pool, src, peer = pair(cfg, params, handoff=True)
    streams, summary = serve_handed_off(
        L, src, peer, prompts[:8], [(i % 4 != 3, kw) for i, (_, kw)
                                    in enumerate(kinds[:8])],
        new_tokens, 10, watcher)
    ack = L.read_checkpoint_ack(alloc, h) or {}
    ps = pool.stats()
    print(f"handoff drain: {summary}; ack kind {ack.get('kind')} "
          f"handoff_streams {ack.get('handoff_streams')}; published "
          f"{ps['published_streams']}, adopted {ps['adopted_streams']}, "
          f"expired {ps['expired_streams']}")
    if (ack.get("kind") != "drained" or ack.get("handoff_streams") != 8
            or summary["handoff_streams"] != 8
            or ps["published_streams"] != ps["adopted_streams"]
            or ps["expired_streams"] or ps["pending_streams"]
            or any(s is None or len(s) != new_tokens for s in streams)):
        fail(f"handoff drain: summary {summary}, ack {ack}, pool {ps}")
    out["handoff"] = dict(summary, ack_kind=ack.get("kind"),
                          published=ps["published_streams"],
                          adopted=ps["adopted_streams"])
    _leak_check("handoff", pool.used_blocks, pool.prefix_cache.cached_blocks,
                pool.prefix_cache)
    del pool, src, peer

    # float32 two-layer copy, greedy: every route gives the same streams
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params32 = W.params_from_jax(dict(tree, layers=tree["layers"][:2]),
                                 cfg32, device=dev)
    few, n32 = prompts[:8], 32
    greedy = [(i % 2 == 0, {}) for i in range(8)]
    runs = {}
    for cached in (False, True):
        e = W.ServingEngine(params32, cfg32, prefix_cache=cached, **eng_kw)
        runs["cached" if cached else "uncached"] = serve(W, e, few, greedy,
                                                         n32)
    pid = e.register_prefix(system)
    runs["explicit"] = serve(W, e, [p[SYSTEM_TOKENS:] for p in few],
                             [(True, dict(prefix=pid))] * 8, n32)
    _, pre, dec = pair(cfg32, params32)
    runs["disaggregated"] = serve_disaggregated(
        pre, dec, few, greedy, ["batch"] * 8, n32)[0]
    _, src, peer = pair(cfg32, params32, handoff=True)
    runs["handed_off"] = serve_handed_off(L, src, peer, few, greedy, n32,
                                          10)[0]
    runs["generate"] = [W.generate(params32, [p], cfg32, n32, device=dev)[
        0, len(p):].tolist() for p in few]
    same = {k: v == runs["generate"] for k, v in runs.items()}
    print(f"prefix f32 2-layer, greedy streams equal to generate(): {same}")
    if not all(same.values()):
        fail(f"prefix f32 streams differ: {same}")
    out["f32_streams_equal"] = all(same.values())
    return out


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def _profiled(torch, fn, reps):
    """torch.profiler over ``reps`` calls of fn (after one warm call):
    (the profile, device-busy share of the host wall time, wall us, device
    busy us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU)
    return prof, busy_us / wall_us, wall_us, busy_us


def profile_paths(torch, W, cfg, params, dev, out_dir, train_step):
    """torch.profiler over one forward, over 20 steady decode steps (8
    live greedy rows at ~128 positions) and over 3 train steps
    (``train_step`` runs one): device-busy share of the host wall time
    and the top device ops; tables and traces go to ``out_dir`` unless it
    is None."""
    from torch.autograd import DeviceType

    rng = np.random.default_rng(SEED + 5)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 256)),
                          device=dev)
    eng = W.ServingEngine(params, cfg, slots=8, max_len=512,
                          prompt_buckets=(16, 64, 256), device=dev)
    for _ in range(8):
        eng.admit(rng.integers(0, cfg.vocab, size=128).tolist())
    for _ in range(3):
        eng.step()
    out = {}
    for name, fn, reps in (
        ("forward", lambda: W.forward(params, tokens, cfg, device=dev), 3),
        ("decode_step", eng.step, 20),
        ("train_step", train_step, 3),
    ):
        prof, _, wall_us, busy_us = _profiled(torch, fn, reps)
        avg = prof.key_averages()
        kernels_ = [e for e in avg if e.device_type != DeviceType.CPU]
        top = sorted(kernels_, key=_device_us, reverse=True)[:8]
        out[name] = dict(
            wall_ms_per_call=wall_us / reps / 1e3,
            device_busy_share=busy_us / wall_us,
            device_ms_per_call=busy_us / reps / 1e3,
            top_device_ops=[
                (e.key[:60], _device_us(e) / reps / 1e3, e.count // reps)
                for e in top
            ],
        )
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
                f.write(avg.table(sort_by=(
                    "self_device_time_total"
                    if hasattr(avg[0], "self_device_time_total")
                    else "self_cuda_time_total"), row_limit=40))
            prof.export_chrome_trace(
                os.path.join(out_dir, f"{name}_trace.json"))
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler pass over forward and decode")
    ap.add_argument("--out", default=None,
                    help="directory for the full report and profiler files")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elastic_tpu_agent_torch import kernels
    from elastic_tpu_agent_torch import workloads as W
    from elastic_tpu_agent_torch.workloads import attention as A
    from elastic_tpu_agent_torch.workloads import lifecycle as L
    from elastic_tpu_agent_torch.workloads import moe as M
    from elastic_tpu_agent_torch.workloads import paged_attention as PA
    from elastic_tpu_agent_torch.workloads import quantize as Q
    from elastic_tpu_agent_torch.workloads import request_obs as RO
    from elastic_tpu_agent_torch.workloads import runner as R
    from elastic_tpu_agent_torch.workloads import telemetry as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card {card}")

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build_seconds {time.perf_counter() - t0:.2f}")

    flash = check_flash(torch, A, dev)
    paged = check_paged(torch, PA, dev)
    dkdv, dq, bwd_whole = check_flash_bwd(torch, A, dev)

    cfg = W.ModelConfig(**SMALL, max_seq=1024, dtype=torch.bfloat16)
    tree = W.random_tree(cfg, SEED)
    params = W.params_from_jax(tree, cfg, device=dev)
    flash["launches"], fwd = run_forward(torch, W, A, cfg, params, dev)
    paged["launches"], srv = run_serving(torch, W, PA, cfg, params, tree, dev)
    launches, train = run_train(torch, W, A, cfg, tree, dev)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        runtime = run_runtime(torch, A, dev, tmp)
        drain = run_drain(torch, W, L, T, cfg, params, dev, tmp)
        prefix = run_prefix(torch, W, PA, L, RO, cfg, params, tree, dev, tmp)
    int8 = run_int8(torch, W, PA, Q, R, cfg, tree, params, dev)
    moe_cfg = dataclasses.replace(cfg, moe_experts=MOE_EXPERTS)
    moe = run_moe(torch, W, A, PA, M, W.random_tree(moe_cfg, SEED), dev)
    dkdv["launches"] = launches["flash_bwd_dkdv"]
    dq["launches"] = launches["flash_bwd_dq"]
    kernel_recs = [flash, paged, dkdv, dq]
    for x in kernel_recs:
        print(f"{x['name']} timing: device ms {x['ms']:.4g} (host-paced "
              f"{x['unqueued_ms']:.4g}), plain {x['plain_ms']:.4g}, library "
              f"{x['library_ms']}, bound {x['bound_ms']:.3g} ({x['bound_by']})")
    print(f"flash_bwd whole bf16 backward {bwd_whole['shape']} (delta + "
          f"dK/dV + dQ): device ms {bwd_whole['ms']:.4g} (delta alone "
          f"{bwd_whole['delta_ms']:.4g}), SDPA's whole backward "
          f"{bwd_whole['sdpa_backward_ms']:.4g}")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    report = {"card": card, "forward": fwd, "serving": srv, "train": train,
              "runtime": runtime, "drain": drain, "int8": int8, "moe": moe,
              "prefix": prefix, "kernels": kernel_recs,
              "flash_bwd_whole": bwd_whole}
    if args.profile:
        rng = np.random.default_rng(SEED + 8)
        tokens = torch.tensor(rng.integers(0, cfg.vocab, size=(8, 257)),
                              device=dev)
        one = _train(torch, W, cfg, tree, dev, tokens, 0)[2]
        report["profile"] = profile_paths(
            torch, W, cfg, params, dev,
            args.out and os.path.join(args.out, "profile"), one)
        print(json.dumps({"profile": report["profile"]}))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"paths": {"forward": fwd, "serving": srv,
                                "train": train, "runtime": runtime,
                                "drain": drain, "int8": int8, "moe": moe,
                                "prefix": prefix}}))
    print(json.dumps(
        {"kernels": [{k: x[k] for k in keys} for x in kernel_recs]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
