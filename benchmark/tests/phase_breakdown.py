"""A cell's time split by the program's phase spans, and what a span costs.

    python3 -m benchmark.tests.phase_breakdown --workload <cell> \
        --seed <n> --seconds <s>
    python3 -m benchmark.tests.phase_breakdown --cost

The first runs one traced run of a cell through its driver, as
``benchmark/run.py --trace 1`` does, and prints one JSON line. For each
outer span of the program (``serving.step`` and ``serving.admit``, or
``train.step``) it gives, from the untraced part of the window: the spans'
count and mean host ms, the benchmark's own span's (``step``, ``admit``,
``train_step``) and how much of it the program's phases cover, and the
host ms a parent spends in each phase; from the traced part: the device
ms, the operations and the idle share (of the traced part) under each
phase. Then the device's idle share, the part of it outside every program
span, and the longest idle gaps, each named by the program phase that
covers most of it ("harness" where none does). Run it on a card.

``--cost`` times the span log's open/close on this host: ns a span, the
median of ``--rounds`` rounds of ``--spans`` spans, less an empty loop."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# each outer program span and the benchmark's own span around the same call
PAIRS = {"serve": (("serving.step", "step"), ("serving.admit", "admit")),
         "train": (("train.step", "train_step"),)}


def breakdown(run, pairs, gaps: int = 12) -> dict:
    from benchmark.harness import program_spans as ps

    host = ps.host_part(run) or []
    out = {}
    for parent, theirs in pairs:
        family = parent.split(".")[0] + "."
        mine = ps.named(host, parent)
        kids = [s for v in ps.inside(mine, [
            s for s in host if s.name.startswith(family)
            and s.name != parent]).values() for s in v]
        names = sorted({s.name for s in kids})
        bench = run.untraced_spans(theirs)
        n, bench_ns = max(1, len(mine)), sum(s.t1 - s.t0 for s in bench)
        d = {"n": len(mine), "mean_ms": sum(s.t1 - s.t0 for s in mine)
             / 1e6 / n,
             "bench_n": len(bench), "bench_mean_ms": bench_ns / 1e6
             / max(1, len(bench)),
             "children_cover": sum(s.t1 - s.t0 for s in kids)
             / bench_ns if bench_ns else None,
             "host_ms": {k: sum(s.t1 - s.t0 for s in kids if s.name == k)
                         / 1e6 / n for k in names}}
        if run.trace is not None:
            d["device_ms"] = ps.device_ms_per(run, parent)
            d["launches"] = {}
            for k in names:
                got = ps.launched(run, parent, k)
                d["launches"][k] = None if got is None else (
                    len(got[0]) / got[1])
            d["phase_device_ms"] = {k: ps.device_ms_per(run, parent, k)
                                    for k in names}
            d["idle_pct"] = {k: ps.idle_inside(run, k) for k in names}
        out[parent] = d
    tr = run.trace
    if tr is not None:
        traced = ps.traced_part(run) or []
        outer = [p for p, _ in pairs]
        idle = 100.0 * (1.0 - tr.busy_s() / tr.window_s)
        out["device_idle_pct"] = idle
        out["idle_outside_program_pct"] = idle - (
            ps.idle_inside(run, *outer) or 0.0)
        out["idle_gaps_ms"] = [
            [name, s * 1e3] for name, s in tr.labelled_gaps(
                [s for s in traced if s.name not in outer], gaps)]
    return out


def span_cost(spans: int = 200_000, rounds: int = 7) -> dict:
    from elastic_tpu_agent_torch.workloads.telemetry import SpanLog

    log = SpanLog()
    counters = (("live_rows", 3),)

    def empty():
        t = time.perf_counter_ns()
        for _ in range(spans):
            pass
        return (time.perf_counter_ns() - t) / spans

    def bare():
        t = time.perf_counter_ns()
        for _ in range(spans):
            log.close(log.open("serving.step.forward"))
        return (time.perf_counter_ns() - t) / spans

    def with_counter():
        t = time.perf_counter_ns()
        for _ in range(spans):
            log.close(log.open("serving.step"), counters)
        return (time.perf_counter_ns() - t) / spans

    med = {}
    for f in (empty, bare, with_counter):
        f()
        med[f.__name__] = statistics.median(f() for _ in range(rounds))
    return {"span_ns": med["bare"] - med["empty"],
            "span_with_counter_ns": med["with_counter"] - med["empty"],
            "empty_loop_ns": med["empty"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--spans", type=int, default=200_000)
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.cost:
        print(json.dumps({"span_cost": span_cost(args.spans, args.rounds)}),
              flush=True)
        return 0
    for key, rel in {"TRITON_CACHE_DIR": ".bench_cache/triton",
                     "TORCH_EXTENSIONS_DIR":
                     ".bench_cache/torch_extensions"}.items():
        os.environ[key] = str(ROOT / rel)
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(key, "1")
    from benchmark.harness import device as dev
    from benchmark.harness import spec

    start = dev.process_start()
    entry = spec.cell_entry(spec.load_benchmark(), args.workload)
    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    dev.require(torch, int(entry["chips"]))
    torch.cuda.set_device(0)
    from benchmark.drivers.common import Context

    ctx = Context(torch=torch, device="cuda", cell_name=args.workload,
                  cell=cell, config=spec.load_config(entry["config"]),
                  seed=args.seed, seconds=args.seconds, traced=True,
                  process_start=start)
    run, outcome = spec.driver(cell["driver"]).run(ctx)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": outcome.correct,
           **breakdown(run, PAIRS[cell["driver"]])}
    print(json.dumps(out), flush=True)
    return 0 if outcome.correct else 1


if __name__ == "__main__":
    sys.exit(main())
