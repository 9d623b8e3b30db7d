"""What every driver shares: the run's context, its outcome, the port's
model configuration, and the window's traced part."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Optional

from ..harness.model import sizes


@dataclasses.dataclass
class Context:
    torch: object
    device: str
    cell_name: str
    cell: Dict
    config: Dict
    seed: int
    seconds: float
    traced: bool
    process_start: float
    control: bool = False

    @property
    def sizes(self) -> Dict:
        return sizes(self.config)

    def since_start(self) -> float:
        """Seconds since the process started (set-up's phases)."""
        return time.time() - self.process_start


def within(checks: Dict[str, tuple]) -> bool:
    """Whether every compared value is within its limit."""
    return all(v is not None and v <= lim for v, lim in checks.values())


@dataclasses.dataclass
class Outcome:
    """``checks``: each compared number's name -> (value, limit); the run
    is correct when every value is within its limit and ``sound``.
    ``controls`` (``--control`` runs only): the lower-precision control's
    and each planted fault's readings under the same limits, by name;
    each has to come out not correct."""

    attempted: int
    failed: int
    checks: Dict[str, tuple]
    sound: bool = True
    notes: Dict = dataclasses.field(default_factory=dict)
    controls: Dict[str, Dict[str, tuple]] = dataclasses.field(
        default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.sound and within(self.checks)


def port_config(torch, s: Dict):
    """The port's ``ModelConfig`` for sizes ``s``."""
    from elastic_tpu_agent_torch.workloads.transformer import ModelConfig

    return ModelConfig(
        vocab=s["vocab"], d_model=s["d"], n_heads=s["n"],
        n_layers=s["layers"], d_ff=s["ff"], max_seq=s["max_seq"],
        dtype=getattr(torch, s["dtype"]),
        n_kv_heads=0 if s["g"] == s["n"] else s["g"], pos=s["pos"],
        rope_theta=s["rope_theta"], window=s["window"],
    )


def trace_bounds(cell: Dict, t0: int, seconds: float):
    """(start, end) in ns of the traced part of a window starting at t0:
    the cell's last ``trace_seconds``, at most half the window. The
    profiler slows a host-bound loop, so it runs last and the host-clock
    readings of a traced run come from the part before it."""
    length = min(float(cell.get("trace_seconds", seconds)), seconds / 2)
    start = t0 + int((seconds - length) * 1e9)
    return start, start + int(length * 1e9)


def free_device(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(torch) -> Optional[int]:
    if torch.cuda.is_available():
        return int(torch.cuda.max_memory_allocated())
    return None
