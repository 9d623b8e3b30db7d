"""Run-to-run readings of the usage reports behind ``chip_smoke.py``'s
phase 30, through the script's own tenants and phase.

* ``--noise CONDS`` runs phase 30's B workload (phase 6's preset and
  token file at ``REP_B_SHAPE``, ``--steps`` steps) outside any pod, once
  for each comma-separated condition: ``alone``, or ``withO`` beside O's
  workload (``REP_O_SHAPE``, stopped when B's run ends). Each run prints
  B's usage-report windows (its start-up window left out), their p50 and
  the runner's ``step_time_ms``. How far those p50s move run to run is
  what phase 30's sizing of B's grant has to absorb.
* ``--phase30 N`` runs phase 4 once and then ``run_repartition`` N times,
  printing each run's grants, B's sizing windows, B's usage reports, the
  controller's moves and the checks that failed.

Needs the card, as ``chip_smoke.py`` does:

    python3 -m elastic_tpu_agent_torch.share_scan --noise alone,withO
    python3 -m elastic_tpu_agent_torch.share_scan --phase30 3 --out DIR

``--out DIR`` keeps every reading in ``DIR/share_scan.json``. Exits 1 if
a phase-30 check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _noise(C, D, conds, steps) -> list:
    """B's windows in one run a condition, outside any pod."""
    d = tempfile.mkdtemp(prefix="share_scan", dir="/tmp")
    data = C._runtime_data(D, os.path.join(d, "tokens.bin"))
    b_args = (f"{data} {C.REP_B_SHAPE} --steps {steps} --warmup-steps 5 "
              f"--total-steps {steps} --checkpoint-every 0")
    o_args = (f"{data} {C.REP_O_SHAPE} --steps {C.REP_O_STEPS} "
              f"--warmup-steps 5 --total-steps {C.REP_O_STEPS} "
              f"--checkpoint-every 0")
    out = []
    for i, cond in enumerate(conds):
        run = os.path.join(d, f"run{i}")
        go = os.path.join(run, "go")
        os.makedirs(go)
        roles = (("b", b_args), ("o", o_args))[:2 if cond == "withO" else 1]
        tenants = {name: C._Tenant(
            f"{name}{i}", "train", run, env=dict(
                TPU=f"{name}{i}", ELASTIC_TPU_ALLOC_DIR=run,
                ELASTIC_TPU_RESTORE_WAIT_S="0"),
            strip=C.PLUGIN_ENV_STRIP, barrier=go, runner_args=args,
            usage_report=True) for name, args in roles}
        deadline = time.time() + C.TENANT_TIMEOUT_S
        while len(os.listdir(go)) < len(tenants):
            if time.time() > deadline:
                raise TimeoutError(f"tenants not ready in {go}")
            time.sleep(0.05)
        open(os.path.join(go, "go"), "w").close()
        rep = tenants["b"].result(time.perf_counter() + C.TENANT_TIMEOUT_S)
        for t in tenants.values():
            t.kill()
        windows = [v for t, v in rep.get("usage_reports", [])
                   if rep["work_start"] < t
                   <= rep["work_end"] + C.REP_REPORT_S][1:]
        row = dict(cond=cond, windows=windows,
                   p50=float(C.np.median(windows)) if windows else None,
                   step_ms=(rep.get("report") or {}).get("step_time_ms"))
        print("noise", json.dumps(row), flush=True)
        out.append(row)
    return out


def _phase30(C, runs) -> list:
    """Phase 4 once, then phase 30 ``runs`` times."""
    import torch

    from elastic_tpu_agent_torch import workloads as W
    from elastic_tpu_agent_torch.workloads import data as D
    from elastic_tpu_agent_torch.workloads import paged_attention as PA

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = W.ModelConfig(**C.SMALL, max_seq=1024, dtype=torch.bfloat16)
    tree = W.random_tree(cfg, C.SEED)
    params = W.params_from_jax(tree, cfg, device=dev)
    _, srv = C.run_serving(torch, W, PA, cfg, params, tree, dev)
    streams = srv.pop("streams")
    out = []
    for i in range(runs):
        n = len(C.FAILURES)
        t0 = time.perf_counter()
        r = C.run_repartition(torch, D, srv, streams, dev)
        row = dict(seconds=round(time.perf_counter() - t0, 2),
                   grants=r.get("grants"), sizing=r.get("sizing"),
                   b_reports=[v for _, v in (r.get("reports") or {}).get(
                       "pod-b") or []],
                   moves=r.get("moves"), host_ms=r.get("host_ms"),
                   failures=C.FAILURES[n:])
        print(f"phase30 run {i}", json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noise", default="",
                    help="comma-separated conditions: alone, withO")
    ap.add_argument("--steps", type=int, default=200,
                    help="B's steps a noise run")
    ap.add_argument("--phase30", type=int, default=0,
                    help="runs of chip_smoke's phase 30")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    import chip_smoke as C

    from elastic_tpu_agent_torch import kernels
    from elastic_tpu_agent_torch.workloads import data as D

    kernels.build_all()
    smi = C.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card {smi}", flush=True)
    report = dict(card=smi)
    if args.noise:
        report["noise"] = _noise(C, D, args.noise.split(","), args.steps)
    if args.phase30:
        report["phase30"] = _phase30(C, args.phase30)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "share_scan.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 1 if C.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
