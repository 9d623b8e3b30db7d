"""Readings of the card checks with planted faults.

Copies the repository (without ``.git``, build outputs and run outputs)
once per fault, plants the fault by replacing one exact line in the
copy's CUDA source or runner, runs the copy's ``chip_smoke.py`` and keeps
its output; the sound tree is run the same way first. The bf16 limits in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``, and its resume limit,
sit between the sound readings and the faulty ones. Needs the card, as
``chip_smoke.py`` does:

    python3 -m elastic_tpu_agent_torch.planted_faults --out DIR [--only F...]

``DIR`` gets one ``<fault>.log`` per run and ``faults.json``: for each
run its exit code, the readings of the kernel, forward, serving, training,
runtime, drain, int8 and MoE checks, and the checks that failed. ``--only`` runs the named
runs alone.

The backward faults F6-F8 and F12 sit in the bf16 (wgmma/TMA) instances
of ``csrc/flash_bwd.cu``, the ones the bf16 checks and the train step run:
F6 in dQ, F7, F8 and F12 in dK/dV. F12 reads lse and delta by the
accumulator fragment's row instead of its column, the slip that the
transposed scores of dK/dV invite.

The restore faults F13-F15 sit in the runner's resume from a full
checkpoint, which chip_smoke's resume check reads: the optimizer state
left at its init, the step count (which drives the schedule and the bias
correction) reset, the second moment reset.

The MoE faults F16-F17 sit in ``workloads/moe.py``, which chip_smoke's
MoE layer check holds against the JAX layer's one-hot einsum form: the
combine drops the gate (y is the expert output), and slot positions are
read one late, so that each expert admits C + 1 tokens.

Two roundings cannot be planted away: P in the bf16 flash forward and dS
in the bf16 backward (F5, "ds not cast before dK", retired) are register
A operands of a bf16 wgmma, so the rounding to bf16 (``pack_bf16``) is
the only way into the product.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BWD = "elastic_tpu_agent_torch/csrc/flash_bwd.cu"
FWD = "elastic_tpu_agent_torch/csrc/flash_fwd.cu"
PAGED = "elastic_tpu_agent_torch/csrc/paged_decode.cu"
RUNNER = "elastic_tpu_agent_torch/workloads/runner.py"
RESTORE = "params, opt_state, start_step = ckpt.restore(params, opt_state)"
MOE = "elastic_tpu_agent_torch/workloads/moe.py"

# name -> (file, exact text, replacement); each text occurs exactly once
FAULTS = {
    "sound": None,
    "F6_delta_dropped": (
        BWD, "d2[e] = p * (dp[j] - dl[h]) * scale;",
        "d2[e] = p * dp[j] * scale;",
    ),
    "F7_gqa_sum_over_wrong_heads": (
        BWD, "return kvh * group + (wg + WGS * it) / nq;",
        "return (wg + WGS * it) / nq * kv_heads + kvh;",
    ),
    "F8_q_tile_lower_bound_one_late": (
        BWD, "const int q_lo = CAUSAL ? (int)blockIdx.y : 0;",
        "const int q_lo = CAUSAL ? (int)blockIdx.y + 1 : 0;",
    ),
    "F12_lse_delta_read_by_row": (
        BWD, "const int c = 8 * (j >> 2) + 2 * t + e;  // the element's q",
        "const int c = 16 * warp + g + 8 * ((j >> 1) & 1);"
        "  // the element's q",
    ),
    "F9_bf16_causal_mask_one_column_late": (
        FWD, "bool keep = rel >= 0;  // row >= col",
        "bool keep = rel >= -1;  // row >= col",
    ),
    "F10_paged_length_one_short": (
        PAGED, "    end = min(len, nb * bs);\n",
        "    end = min(len - 1, nb * bs);\n",
    ),
    "F11_split_merged_without_rescale": (
        PAGED, "const float w = exp2_approx(__ldcg(pk) - mx);",
        "const float w = 1.f;",
    ),
    "F13_optimizer_state_reinitialised_on_resume": (
        RUNNER, RESTORE,
        "params, _, start_step = ckpt.restore(params, opt_state)",
    ),
    "F14_step_count_reset_on_resume": (
        RUNNER, RESTORE, RESTORE + '; opt_state["count"].zero_()',
    ),
    "F15_second_moment_reset_on_resume": (
        RUNNER, RESTORE,
        RESTORE + '; opt_state["nu"] = optimizer.init(params)["nu"]',
    ),
    "F16_moe_combine_drops_the_gate": (
        MOE, "y = torch.where(kept[:, None], gate.to(dtype)[:, None] * picked,",
        "y = torch.where(kept[:, None], picked,",
    ),
    "F17_moe_slot_positions_one_late": (
        MOE, "kept = position <= cap", "kept = position - 1 <= cap",
    ),
}
TIMEOUT_S = 900.0  # for each chip_smoke.py run
KEEP = ("card ", "flash_fwd ", "paged_decode ", "flash_bwd", "forward ",
        "serving ", "train ", "reference losses", "runtime ", "moe ",
        "int8 ", "kv_int8 ", "recorder", "drain", "chip_smoke:")
SKIP = (".git", "_build", "__pycache__", ".pytest_cache")


def plant(tree: Path, fault) -> None:
    if fault is None:
        return
    rel, old, new = fault
    path = tree / rel
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{rel}: {old!r} occurs {text.count(old)} times")
    path.write_text(text.replace(old, new))


def run(name: str, fault, out: Path) -> dict:
    tree = out / "trees" / name
    shutil.rmtree(tree, ignore_errors=True)
    # the output directory may lie inside the repository: never copy it
    top = out.relative_to(ROOT).parts[0] if out.is_relative_to(ROOT) \
        else None

    def ignore(path, names):
        return [n for n in names
                if n in SKIP or (Path(path) == ROOT and n == top)]

    shutil.copytree(ROOT, tree, ignore=ignore)
    plant(tree, fault)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
        text=True, timeout=TIMEOUT_S,
    )
    text = proc.stdout + proc.stderr
    (out / f"{name}.log").write_text(text)
    shutil.rmtree(tree, ignore_errors=True)
    lines = text.splitlines()
    return dict(
        rc=proc.returncode, seconds=time.perf_counter() - t0,
        readings=[x for x in lines if x.startswith(KEEP)],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="directory for the logs")
    ap.add_argument("--only", nargs="+", choices=sorted(FAULTS),
                    default=list(FAULTS), help="the runs to make")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    results = {}
    for name in args.only:
        results[name] = run(name, FAULTS[name], out)
        print(name, "rc", results[name]["rc"], flush=True)
    (out / "faults.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
