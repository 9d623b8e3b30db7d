"""Arithmetic that the metric readers share: times of requests and steps
in a run's window, and kernel rooflines over a traced window.

A reader returns None where the run holds nothing to read; the harness
then leaves the metric out."""

from __future__ import annotations

from typing import List, Optional

from . import flops, peaks
from .model import param_count
from .paged_traffic import kernel_traffic
from .stats import mean, percentile


def ttft_ms(run) -> List[float]:
    """Each request due in the window (in a traced run, before the
    profiler started), from when it was due to its first token on the
    host; one with no first token by then (still queued, or refused)
    counts with its wait so far."""
    end = run.untraced_end
    out = []
    for r in run.requests:
        if r["due"] >= end:
            continue
        first = r.get("admit_t1")
        at = first if first is not None and first <= end else end
        out.append((at - r["due"]) / 1e6)
    return out


def token_gaps_ms(run) -> List[float]:
    """Every gap between consecutive tokens of every request (in a traced
    run, those that closed before the profiler started)."""
    end = run.untraced_end
    out = []
    for r in run.requests:
        ts = [t for t in r.get("tokens_ns", []) if t <= end]
        out += [(b - a) / 1e6 for a, b in zip(ts, ts[1:])]
    return out


def admitted(run) -> List[dict]:
    """Requests whose admit call ended (before the profiler started)."""
    return [r for r in run.requests
            if r.get("admit_t1", run.untraced_end + 1) <= run.untraced_end]


def p95(values) -> Optional[float]:
    return percentile(values, 95) if values else None


def p50(values) -> Optional[float]:
    return percentile(values, 50) if values else None


def span_mean_ms(run, name: str) -> Optional[float]:
    spans = run.untraced_spans(name)
    return mean([s.seconds * 1e3 for s in spans]) if spans else None


def prefill_mfu(run) -> Optional[float]:
    """Model FLOPs of the admitted prompts (unpadded) over the admissions'
    host time at the bf16 peak, in %."""
    rs = admitted(run)
    if not rs:
        return None
    n = param_count(run.sizes)["non_embedding"]
    work = sum(flops.prefill_flops(run.sizes, n, len(r["prompt"]))
               for r in rs)
    busy = sum(r["admit_t1"] - r["admit_t0"] for r in rs) / 1e9
    return 100.0 * work / (busy * peaks.peak("bf16_flops"))


def decode_mfu(run) -> Optional[float]:
    """Model FLOPs of the decode steps (a token for each live row, at its
    length) over the steps' host time at the bf16 peak, in % (in a traced
    run, the steps before the profiler started)."""
    steps = run.untraced_spans("step")
    if not steps:
        return None
    n = param_count(run.sizes)["non_embedding"]
    work = sum(flops.decode_step_flops(run.sizes, n, s.info["lengths"])
               for s in steps)
    busy = sum(s.seconds for s in steps)
    return 100.0 * work / (busy * peaks.peak("bf16_flops"))


def train_mfu(run) -> Optional[float]:
    """Model FLOPs of the window's steps over their time at the bf16 peak,
    in % (in a traced run, the steps before the profiler started)."""
    steps = [s for s in run.steps if s["end"] <= run.untraced_end]
    if not steps:
        return None
    t = run.cell["traffic"]
    n = param_count(run.sizes)["non_embedding"]
    work = len(steps) * flops.train_step_flops(
        run.sizes, n, int(t["rows"]), int(t["seq"]))
    seconds = (steps[-1]["end"] - run.window[0]) / 1e9
    return 100.0 * work / (seconds * peaks.peak("bf16_flops"))


def device_idle(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def roofline(bound_s: float, kernel_s: float) -> Optional[float]:
    return 100.0 * bound_s / kernel_s if kernel_s > 0 else None


def paged_decode_roofline(run) -> Optional[float]:
    """Summed bounds over summed time of the traced window's paged-decode
    launches: each decode step launches one a layer, in order, at the
    live requests' lengths (prompt + tokens so far, the step's write
    included)."""
    if run.trace is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    steps = [s for s in run.spans_named("step") if t0 <= s.t0 and s.t1 <= t1]
    kernels = run.trace.named("paged_split_kernel")
    per = run.sizes["layers"]
    if not steps or len(kernels) != per * len(steps):
        return None
    e, s = run.cell["engine"], run.sizes
    bound = 0.0
    for st in steps:
        lengths = st.info["lengths"]
        tr = kernel_traffic(
            len(lengths), -(-e["max_len"] // e["block_size"]),
            e["block_size"], s["g"], s["h"], 2, n_heads=s["n"],
            lengths=lengths, window=s["window"])
        bound += per * peaks.bound_s(tr["flops"], tr["bytes"])
    took = sum(b - a for _, a, b, _ in kernels) / 1e9
    return roofline(bound, took)


def flash_roofline(run, names, traffic_fn) -> Optional[float]:
    """Summed bounds over summed time of the traced window's launches of
    the kernels named ``names`` (one call of the attention a layer and
    micro-batch, each launching every one of them once)."""
    if run.trace is None:
        return None
    groups = [run.trace.named(n) for n in names]
    if not groups[0] or any(len(g) != len(groups[0]) for g in groups):
        return None
    t, s = run.cell["traffic"], run.sizes
    accum = int(t.get("accum_steps", 1))
    tr = traffic_fn(int(t["rows"]) // accum, s["n"], s["g"], s["h"],
                    int(t["seq"]), 2, s["window"])
    bound = len(groups[0]) * peaks.bound_s(tr["flops"], tr["bytes"])
    took = sum(b - a for g in groups for _, a, b, _ in g) / 1e9
    return roofline(bound, took)


def optimizer_ms(run) -> Optional[float]:
    """Device ms a step of the operations launched inside the spans around
    the optimizer's update, over the traced window's steps."""
    if run.trace is None:
        return None
    spans = [s for s in run.spans_named("optimizer")
             if run.trace.t0 <= s.t0 and s.t1 <= run.trace.t1]
    ops = run.trace.launched_within(spans) if spans else None
    if not ops:
        return None
    return sum(b - a for _, a, b, _ in ops) / 1e6 / len(spans)
