"""The card a run measures, and the process's own start."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict

FORBIDDEN = ("jax", "jaxlib", "flax", "elastic_tpu_agent")


class NoChip(SystemExit):
    """The run cannot measure: exits with code 3 and prints no result."""

    def __init__(self, why: str):
        print(f"benchmark: {why}", file=sys.stderr)
        super().__init__(3)


def require(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"{torch.cuda.device_count()} card(s), the cell asks "
                     f"for {chips}")


def describe(torch, chips: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def card_limits() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc; the
    interpreter's start-up is set-up too)."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Top-level module names of JAX or the JAX package loaded in this
    process, compared whole (the port's name begins with the JAX
    package's)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))
