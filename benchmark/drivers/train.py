"""Training cells: the port's ``make_train_step`` on batches from the seed.

Set-up makes float32 parameters on the device from the seed (the step
computes in the configuration's dtype, as the port stores them), builds
the step and the optimizer state, and runs the first three steps through
the same call and feed as the window, on batches 0-2: they warm every
shape and give the check its readings, read from the program's own
output before step 4 changes it: each step's loss, each leaf's first
gradient as the optimizer got it (its first moment after one step over
1 - b1) and each leaf's change after three steps (against the initial
parameters, made again from the seed). The window then runs steps 4, 5,
... until its length has passed, each ending on its loss's copy to the
host, as a training loop that logs its loss does.

The check (after the window, with the program's state freed): the float32
reference trains a copy of the initial parameters, made again from the
seed, for three steps on the same batches, and each reading of the program
is held against it (``compare``)."""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

from ..harness import spec
from ..harness.model import make_head, make_layer, make_params
from ..harness.record import Run, now_ns
from ..harness.trace import DeviceTracer
from ..reference import model as ref
from ..reference.quant import fp8_mm
from .common import (Context, Outcome, free_device, peak_bytes, port_config,
                     trace_bounds)

CHECKED_STEPS = 3
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam; their change is not compared
STILL_LEAF = 1e-3


def _norms(torch, tree: Dict, paths, scale: float = 1.0) -> List[float]:
    return [float(torch.linalg.vector_norm(ref.leaf(tree, p).float()))
            * scale for p in paths]


def change_norms(torch, ctx: Context, tree: Dict, paths) -> List[float]:
    """Each leaf's distance from the initial parameters, made again from
    the seed one group at a time."""
    s = ctx.sizes
    f32 = torch.float32
    first = {"head": make_head(torch, s, ctx.seed, ctx.device, f32)}
    out = []
    for p in paths:
        if p[0] == "layers":
            key = ("layer", p[1])
            if key not in first:
                first = {"head": first["head"],
                         key: make_layer(torch, s, ctx.seed, p[1],
                                         ctx.device, f32)}
            base = first[key][p[2]]
        else:
            base = first["head"][p[0]]
        out.append(float(torch.linalg.vector_norm(
            ref.leaf(tree, p).float() - base)))
    return out


def readings(losses, grads, changes) -> Dict:
    return dict(losses=list(losses), grads=list(grads),
                changes=list(changes))


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The gaps of ``got``'s readings from the reference's ``want``:
    ``loss_gap`` the largest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap`` the worst leaf's gap of norms over the
    larger of that leaf's and the median leaf's reference norm, the change
    leaving out leaves whose reference gradient is under STILL_LEAF of
    the median leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"]))
    g_med = statistics.median(want["grads"])
    grad = max(abs(a - b) / max(b, g_med)
               for a, b in zip(got["grads"], want["grads"]))
    kept = [i for i, g in enumerate(want["grads"]) if g >= STILL_LEAF * g_med]
    c_med = statistics.median(want["changes"][i] for i in kept)
    change = max(abs(got["changes"][i] - want["changes"][i])
                 / max(want["changes"][i], c_med) for i in kept)
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change)


def run(ctx: Context):
    from elastic_tpu_agent_torch.workloads.transformer import make_train_step

    torch, s = ctx.torch, ctx.sizes
    traffic, train = ctx.cell["traffic"], ctx.cell["train"]
    run = Run(ctx.cell_name, ctx.cell, ctx.config, s, ctx.seed, ctx.seconds,
              ctx.traced)
    phases = run.counters["setup_phases"] = {"start": ctx.since_start()}
    params = make_params(torch, s, ctx.seed, ctx.device, torch.float32)
    phases["weights"] = ctx.since_start()
    train_step, _, optimizer = make_train_step(
        port_config(torch, s), learning_rate=train["learning_rate"],
        accum_steps=int(traffic.get("accum_steps", 1)), device=ctx.device)
    opt_state = optimizer.init(params)
    if ctx.traced:
        update = optimizer.update_

        def spanned_update(*args, **kw):
            with run.span("optimizer"):
                return update(*args, **kw)

        optimizer.update_ = spanned_update

    feed = spec.traffic_kind(traffic["kind"])

    def step(i: int) -> float:
        tokens = feed.batch(torch, traffic, ctx.seed, i, s["vocab"],
                            ctx.device)
        with run.span("train_step", step=i):
            loss = train_step(params, opt_state, tokens)[2]
        with run.span("loss_read", step=i):
            return float(loss)

    paths = ref.leaf_paths(params)
    losses = [step(0)]
    grads = _norms(torch, opt_state["mu"], paths, 1.0 / (1.0 - optimizer.b1))
    losses += [step(i) for i in range(1, CHECKED_STEPS)]
    program = readings(losses, grads, change_norms(torch, ctx, params, paths))
    program["paths"] = paths
    phases["checked_steps"] = ctx.since_start()
    tracer = DeviceTracer(torch) if ctx.traced else None
    if tracer is not None:
        tracer.warm()
    run.spans.clear()

    run.setup_s = time.time() - ctx.process_start
    t0 = now_ns()
    end = t0 + int(ctx.seconds * 1e9)
    trace_at = trace_bounds(ctx.cell, t0, ctx.seconds) if tracer else None
    i, now = CHECKED_STEPS, t0
    while now < end:
        if trace_at is not None:
            if run.trace is None and not tracer.active \
                    and now >= trace_at[0]:
                tracer.start()
            elif tracer.active and now >= trace_at[1]:
                run.trace = tracer.stop()
        loss = step(i)
        now = now_ns()
        run.steps.append(dict(step=i, end=now, loss=loss))
        i += 1
    if trace_at is not None and tracer.active:
        run.trace = tracer.stop()
    run.window = (t0, now)
    run.counters.update(memory_peak_bytes=peak_bytes(torch),
                        tokens_per_step=feed.tokens_per_step(traffic))

    del params, opt_state, train_step, optimizer
    free_device(torch)
    checks, notes, controls = check(ctx, program)
    return run, Outcome(attempted=len(run.steps), failed=0, checks=checks,
                        notes=notes, controls=controls)


def reference_readings(ctx: Context, mm=ref.f32_mm,
                       rows=None) -> Tuple[Dict, float]:
    """The reference's readings over the checked steps; ``rows`` keeps only
    the first that many rows of each batch (a planted fault: half of the
    batch left out, the mean taken over the rest)."""
    torch, s = ctx.torch, ctx.sizes
    traffic, train = ctx.cell["traffic"], ctx.cell["train"]
    t = time.perf_counter()
    tree = make_params(torch, s, ctx.seed, ctx.device, torch.float32)
    paths = ref.leaf_paths(tree)
    opt = ref.AdamW(train["learning_rate"], train["weight_decay"])
    losses, grads = [], None
    with ref.no_tf32():
        for i in range(CHECKED_STEPS):
            tokens = spec.traffic_kind(traffic["kind"]).batch(
                torch, traffic, ctx.seed, i, s["vocab"], ctx.device)
            tokens = tokens.reshape(-1, tokens.shape[-1])[:rows]
            loss, g = ref.loss_and_grads(
                tree, tokens, s, ctx.cell["check"]["rows_per_block"], mm)
            losses.append(loss)
            if grads is None:
                grads = [float(torch.linalg.vector_norm(g[p])) for p in paths]
            opt.step({p: ref.leaf(tree, p) for p in paths}, g)
            del g
    out = readings(losses, grads, change_norms(torch, ctx, tree, paths))
    del tree, opt
    free_device(torch)
    return out, time.perf_counter() - t


def worst_leaves(got: Dict, want: Dict, paths) -> Dict[str, str]:
    """The leaf behind each of ``compare``'s leaf gaps (for the record)."""
    out = {}
    for key in ("grads", "changes"):
        med = statistics.median(want[key])
        gap = [abs(a - b) / max(b, med) for a, b in zip(got[key], want[key])]
        out[key] = "/".join(map(str, paths[gap.index(max(gap))]))
    return out


def check(ctx: Context, program: Dict):
    want, seconds = reference_readings(ctx)
    gaps = compare(program, want)
    limits = ctx.cell["check"]["limits"]
    g_med = statistics.median(want["grads"])
    notes = dict(reference_s=seconds, program_losses=program["losses"],
                 reference_losses=want["losses"],
                 worst_leaves=worst_leaves(program, want,
                                           program["paths"]),
                 still_leaves=["/".join(map(str, p)) for p, g in zip(
                     program["paths"], want["grads"])
                     if g < STILL_LEAF * g_med])
    # a number with no limit is read for the record and not compared
    notes["not_compared"] = {k: v for k, v in gaps.items() if k not in limits}
    controls = {}
    if ctx.control:
        # the reference in fp8 products, and with half of each batch left
        # out, in the program's place; a state left unchanged needs no run
        low, _ = reference_readings(ctx, mm=fp8_mm)
        rows = int(ctx.cell["traffic"]["rows"]) // 2
        half, _ = reference_readings(ctx, rows=rows)
        still = dict(want, changes=[0.0] * len(want["changes"]))
        for name, got in (("control_fp8", low), ("fault_half_batch", half),
                          ("fault_state_unchanged", still)):
            read = compare(got, want)
            controls[name] = {k: (read[k], lim) for k, lim in limits.items()}
    return {k: (gaps[k], lim) for k, lim in limits.items()}, notes, controls
