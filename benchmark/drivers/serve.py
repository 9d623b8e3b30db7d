"""Serving cells: the port's ``ServingEngine`` under open-loop traffic.

Set-up makes the weights on the device from the seed, builds the engine as
the cell's ``engine`` block says, and warms every prompt bucket and the
decode step. The window then replays the schedule of the cell's traffic
kind (``traffic/<kind>.py``'s ``schedule``) in one thread: each due request waits in a FIFO until a slot is free and
is admitted (``admit``: the whole prefill, ending on the first token's
copy to the host) before the next decode step; ``step`` advances every
live request by one token and ends synced, as it returns host ints; a
request is released once it has its drawn number of tokens. With nothing
live and nothing due, the loop sleeps until the next request is due.

The check (after the window, with the engine freed): a sample of the
finished requests, drawn from the seed and holding the longest, goes
through the float32 reference over each prompt and its served tokens;
the number compared is the widest gap by which a served token's
reference logit lies below the reference's best at its position (greedy
decoding, so a sound program serves the best token up to its rounding).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np

from ..harness import readers, spec
from ..harness.model import make_head, make_layer, make_params, torch_dtype
from ..harness.record import Run, now_ns
from ..harness.seeds import derive
from ..harness.trace import DeviceTracer
from ..reference import model as ref
from ..reference.quant import fp8_mm
from .common import (Context, Outcome, free_device, peak_bytes, port_config,
                     trace_bounds)


def _engine(ctx: Context, params):
    from elastic_tpu_agent_torch.workloads.serving import ServingEngine

    e = ctx.cell["engine"]
    return ServingEngine(
        params, port_config(ctx.torch, ctx.sizes), slots=e["slots"],
        max_len=e["max_len"], prompt_buckets=tuple(e["prompt_buckets"]),
        temperature=0.0, seed=derive(ctx.seed, "engine"),
        block_size=e["block_size"], paged_kernel=e.get("paged_kernel"),
        device=ctx.device,
    )


def _warm(ctx: Context, engine) -> None:
    """One prompt at each bucket's full length, admitted together, then a
    few decode steps: every shape the traffic uses."""
    rng = np.random.default_rng(derive(ctx.seed, "warmup"))
    lo = int(ctx.cell["traffic"]["prompt_len"]["min"])
    hi = int(ctx.cell["traffic"]["prompt_len"]["max"])
    rids = []
    for b in ctx.cell["engine"]["prompt_buckets"]:
        if b < lo:
            continue
        n = min(b, hi)
        rids.append(engine.admit(rng.integers(0, ctx.sizes["vocab"], n,
                                              dtype=np.int32)))
    for _ in range(4):
        engine.step()
    for rid in rids:
        engine.release(rid)


def run(ctx: Context):
    torch, s = ctx.torch, ctx.sizes
    traffic = ctx.cell["traffic"]
    run = Run(ctx.cell_name, ctx.cell, ctx.config, s, ctx.seed, ctx.seconds,
              ctx.traced)
    phases = run.counters["setup_phases"] = {"start": ctx.since_start()}
    params = make_params(torch, s, ctx.seed, ctx.device,
                         torch_dtype(torch, s["dtype"]))
    phases["weights"] = ctx.since_start()
    engine = _engine(ctx, params)
    phases["engine"] = ctx.since_start()
    _warm(ctx, engine)
    phases["warm"] = ctx.since_start()
    reqs = spec.traffic_kind(traffic["kind"]).schedule(
        traffic, ctx.seed, ctx.seconds, s["vocab"])
    tracer = DeviceTracer(torch) if ctx.traced else None
    if tracer is not None:
        tracer.warm()
    slots = ctx.cell["engine"]["slots"]

    run.setup_s = time.time() - ctx.process_start
    t0 = now_ns()
    end = t0 + int(ctx.seconds * 1e9)
    run.window = (t0, end)
    trace_at = trace_bounds(ctx.cell, t0, ctx.seconds) if tracer else None
    tracing = False
    mid = t0 + (end - t0) // 2
    for r in reqs:
        r.update(due=t0 + int(r["due_s"] * 1e9), tokens_ns=[])
    queue: deque = deque()
    live: Dict[int, Dict] = {}
    lateness: List[int] = []
    nxt = failed = 0
    # the pool's peak blocks in use, and the live rows a decode step runs
    pool_peak = 0
    rows: List[int] = []

    def finish(rid: int) -> None:
        r = live.pop(rid)
        with run.span("release"):
            r["tokens"] = engine.release(rid)

    while True:
        now = now_ns()
        if now >= end:
            break
        if trace_at is not None:
            if not tracing and run.trace is None and now >= trace_at[0]:
                tracer.start()
                tracing = True
            elif tracing and now >= trace_at[1]:
                run.trace, tracing = tracer.stop(), False
        if "backlog_mid" not in run.counters and now >= mid:
            run.counters["backlog_mid"] = len(queue)
        while nxt < len(reqs) and reqs[nxt]["due"] <= now:
            queue.append(reqs[nxt])
            nxt += 1
        if queue and len(live) < slots:
            r = queue.popleft()
            r["admit_t0"] = now_ns()
            try:
                with run.span("admit"):
                    rid = engine.admit(r["prompt"])
            except ValueError as e:
                r["failed"] = str(e)
                failed += 1
                continue
            r["admit_t1"] = now_ns()
            r["tokens_ns"].append(r["admit_t1"])
            live[rid] = r
            pool_peak = max(pool_peak, engine.used_blocks)
            if r["output_len"] <= 1:
                finish(rid)
            continue
        if live:
            lengths = [len(r["prompt"]) + len(r["tokens_ns"])
                       for r in live.values()]
            with run.span("step", lengths=lengths) as sp:
                out = engine.step()
            rows.append(len(lengths))
            pool_peak = max(pool_peak, engine.used_blocks)
            for rid in out:
                r = live[rid]
                r["tokens_ns"].append(sp.t1)
                if len(r["tokens_ns"]) >= r["output_len"]:
                    finish(rid)
            for rid in [q for q in live if q in engine.finish_reason]:
                finish(rid)      # auto-finished before its length
            continue
        wake = min(reqs[nxt]["due"] if nxt < len(reqs) else end, end)
        with run.span("wait"):
            time.sleep(max(0, wake - now_ns()) / 1e9)
        if wake < end:
            lateness.append(now_ns() - wake)
    if tracing:
        run.trace = tracer.stop()
    run.counters.update(
        backlog_end=len(queue) + sum(1 for r in reqs[nxt:]
                                     if r["due"] < end),
        live_end=len(live), lateness_ns=lateness,
        admitted=sum(1 for r in reqs if "admit_t1" in r),
        finished=sum(1 for r in reqs if "tokens" in r),
        memory_peak_bytes=peak_bytes(torch),
        pool_blocks=engine.pool_blocks, pool_blocks_peak=pool_peak,
        pool_peak_pct=100.0 * pool_peak / (engine.pool_blocks - 1),
        live_rows_mean=sum(rows) / len(rows) if rows else 0.0,
        live_rows_max=max(rows, default=0),
    )
    run.requests = reqs
    run.counters.update(ttft_p50_ms=readers.p50(readers.ttft_ms(run)),
                        tpot_p50_ms=readers.p50(readers.token_gaps_ms(run)))

    finished = [r for r in reqs if "tokens" in r and r["tokens"]]
    del engine, params, live
    free_device(torch)
    checks, notes, controls = check(ctx, finished)
    sound = bool(finished)
    return run, Outcome(attempted=len(reqs), failed=failed, checks=checks,
                        sound=sound, notes=notes, controls=controls)


def sample(finished: List[Dict], seed: int, tokens: int,
           most: int) -> List[Dict]:
    """The longest finished request, then others in an order drawn from
    the seed, until ``tokens`` served tokens or ``most`` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i]["prompt"])
                                   + len(finished[i]["tokens"])))
    rng = np.random.default_rng(derive(seed, "sample"))
    others = order[1:]
    out, count = [], 0
    for i in [order[0]] + [others[j] for j in rng.permutation(len(others))]:
        if count >= tokens or len(out) >= most:
            break
        out.append(finished[i])
        count += len(finished[i]["tokens"])
    return out


def gaps(logits: List, chosen: List) -> float:
    """Widest gap, over every position, between the best reference logit
    and the reference logit of the token chosen there."""
    worst = 0.0
    for lg, tok in zip(logits, chosen):
        best = lg.max(-1).values
        got = lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
    return worst


def check(ctx: Context, finished: List[Dict]):
    torch, s = ctx.torch, ctx.sizes
    spec = ctx.cell["check"]
    chosen = sample(finished, ctx.seed, spec["sample_tokens"],
                    spec["max_requests"])
    dev = ctx.device
    dtype = torch_dtype(torch, s["dtype"])
    seqs = [torch.as_tensor(np.concatenate(
        [r["prompt"], np.asarray(r["tokens"][:-1], np.int32)]),
        dtype=torch.long, device=dev) for r in chosen]
    from_pos = [len(r["prompt"]) - 1 for r in chosen]
    served = [torch.as_tensor(r["tokens"], dtype=torch.long, device=dev)
              for r in chosen]

    def f32(tree):
        return {k: v.float() for k, v in tree.items()}

    def layer_of(i):
        return f32(make_layer(torch, s, ctx.seed, i, dev, dtype))

    limit = spec["limits"]["widest_gap"]
    notes = dict(sampled_requests=len(chosen),
                 sampled_tokens=sum(len(t) for t in served))
    controls = {}
    if not chosen:
        return {"widest_gap": (None, limit)}, notes, controls
    t = time.perf_counter()
    with ref.no_tf32(), torch.no_grad():
        head = f32(make_head(torch, s, ctx.seed, dev, dtype))
        logits = ref.served_logits(seqs, from_pos, s, head, layer_of)
        widest = gaps(logits, served)
        if ctx.control:
            # the reference in fp8 products, in the program's place: at
            # each position of the same tokens, the token it puts first
            low = ref.served_logits(seqs, from_pos, s, head, layer_of,
                                    mm=fp8_mm)
            controls["control_fp8"] = {"widest_gap": (gaps(
                logits, [lg.argmax(-1) for lg in low]), limit)}
    notes["reference_s"] = time.perf_counter() - t
    return {"widest_gap": (widest, limit)}, notes, controls
