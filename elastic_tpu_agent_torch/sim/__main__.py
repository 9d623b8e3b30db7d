"""Replay one compound scenario of the chaos matrix: the command a chaos
report's repro line names (``sim/chaos.py`` ``repro_line``).

    python -m elastic_tpu_agent_torch.sim --trace-seed S --chaos-seed C \\
        --scenario NAME

builds the default matrix on the two seeds, keeps the named scenario at
its index (so that its sub-seeds, and so its trace and program, are those
of the full-matrix run the line came from), runs it on a fresh 2-node
fleet of the port's agents with the agent's smoke floors, prints the
report as one JSON object and exits 1 when ``scale_problems`` finds any
problem. Without ``--scenario`` every scenario of the matrix runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from .chaos import ChaosMatrix

# The agent's chaos smoke floors, on top of the conservation invariants:
# the fleet stays mostly productive and the latency classes mostly meet
# their targets while the program runs.
SMOKE_BOUNDS = {"min_goodput_percent": 10.0, "min_slo_attainment": 0.9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-seed", type=int, default=1)
    ap.add_argument("--chaos-seed", type=int, default=1)
    ap.add_argument("--scenario", default=None)
    args = ap.parse_args(argv)
    matrix = ChaosMatrix(trace_seed=args.trace_seed,
                         chaos_seed=args.chaos_seed)
    specs = [dict(spec, index=i) for i, spec in enumerate(matrix.scenarios)
             if args.scenario in (None, spec["name"])]
    if not specs:
        names = [s["name"] for s in matrix.scenarios]
        print(f"unknown scenario {args.scenario!r}; have {names}",
              file=sys.stderr)
        return 2
    for spec in specs:
        spec["bounds"] = {**SMOKE_BOUNDS, **(spec.get("bounds") or {})}
    matrix.scenarios = specs
    # AF_UNIX socket paths cap at ~107 characters: a short base dir
    with tempfile.TemporaryDirectory(prefix="etpu-chaos-", dir="/tmp") as td:
        out = matrix.run(td)
    print(json.dumps(out, default=str))
    return 1 if out["problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
