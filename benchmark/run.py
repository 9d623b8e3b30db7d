#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``'s entry and ``benchmark/workloads/
<cell>.json``) names its configuration, its driver and its traffic; the
driver builds the program (``elastic_tpu_agent_torch``) from weights it
makes on the device from the seed, warms it, measures for ``--seconds``,
and checks what the measured path produced against the float32 reference.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the profiler's trace of part
of the window and the benchmark's own spans.

Standard error holds the card's name and power limit, the peak memory and
the driver's counters, and, last, each number compared beside its limit.
The last line of standard output is the result, one JSON object.

Exits 3 with no result where the cards are missing, and 4 where JAX or
the JAX package was loaded. ``--rate`` replaces a serving cell's arrival
rate (the knee sweep), and ``--dump`` writes the window's requests or
steps for study. ``--control`` also puts the lower-precision control and
each planted fault in the program's place, judges each under the cell's
own limits, and reports them under ``controls``, each with its
``correct``; such a run exits 5 where any of them comes out correct, as
the limits then do not separate it from the program. The benchmark's own
runs take none of these."""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": ".bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--control", action="store_true")
    p.add_argument("--dump", default=None,
                   help="write each request's or step's times here (JSON)")
    return p.parse_args(argv)


def _say(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device="cpu"`` (tests only) skips the look for a card."""
    args = _args(argv)
    sys.path.insert(0, str(ROOT))
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    for key in THREADS:       # one process with few threads: steadier
        os.environ.setdefault(key, "1")
    from benchmark.harness import device as dev
    from benchmark.harness import spec

    start = dev.process_start()
    bench = spec.load_benchmark()
    entry = spec.cell_entry(bench, args.workload)
    cell = spec.load_cell(args.workload)
    if args.rate is not None:
        cell["traffic"]["rate_per_s"] = args.rate
    config = spec.load_config(entry["config"])

    import torch

    torch.set_num_threads(1)
    if device != "cpu":
        dev.require(torch, int(entry["chips"]))
        torch.cuda.set_device(0)
        _say("card", dev.card_limits(), "| torch", torch.__version__,
             "cuda", torch.version.cuda)
    from benchmark.drivers.common import Context, within

    ctx = Context(torch=torch, device=device, cell_name=args.workload,
                  cell=cell, config=config, seed=args.seed,
                  seconds=args.seconds, traced=bool(args.trace),
                  process_start=start, control=args.control)
    run, outcome = spec.driver(cell["driver"]).run(ctx)

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, args.workload, section):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = dev.describe(torch, int(entry["chips"])) if device != "cpu" else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = run.counters.get("memory_peak_bytes")
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": info}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": run.trace.top_ops(10),
            "idle_gaps": run.trace.labelled_gaps(run.spans, 10)}
    if args.control:
        result["controls"] = {
            name: {"correct": within(c), "checks": _checks(c)}
            for name, c in outcome.controls.items()}
    result["checks"] = _checks(outcome.checks)

    lateness = run.counters.pop("lateness_ns", None)
    if lateness:
        run.counters["lateness_ms_mean"] = sum(lateness) / len(lateness) / 1e6
        run.counters["lateness_ms_max"] = max(lateness) / 1e6
    _say("setup_s", run.setup_s, "window_s", run.window_s)
    _say("counters", json.dumps(run.counters))
    _say("notes", json.dumps(outcome.notes))
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        Path(args.dump).write_text(json.dumps(dict(
            window=run.window, steps=run.steps,
            requests=[{k: v for k, v in r.items() if k != "prompt"}
                      | {"prompt_len": len(r["prompt"])}
                      for r in run.requests])))
    bad = dev.forbidden_modules()
    if bad:
        _say("loaded after the window:", ", ".join(bad), "- no result")
        return 4
    for name, c in outcome.controls.items():
        for k, (v, lim) in c.items():
            _say(f"control {name} {k} {v} limit {lim}")
        _say("control", name, "correct", within(c))
    for k, (v, lim) in outcome.checks.items():
        _say(f"check {k} {v} limit {lim}")
    _say("correct", outcome.correct)
    print(json.dumps(result), flush=True)
    passed = [n for n, c in outcome.controls.items() if within(c)]
    if args.control and (passed or not outcome.controls):
        _say("controls that came out correct:", passed or "none read")
        return 5
    return 0


def _checks(checks) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


if __name__ == "__main__":
    sys.exit(main())
