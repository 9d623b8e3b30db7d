"""In-pod workload flight recorder and the agent-visible sidecar files.

Counterpart of ``elastic_tpu_agent/workloads/telemetry.py``. Per-step
facts from inside the pod:

- wall time per step (dispatch to dispatch: CUDA work is queued
  asynchronously, so in a loop the device bounds it only when it is the
  slower side),
- tokens/s when the caller supplies a token count,
- device memory (``bytes_in_use``, ``peak_bytes_in_use`` and
  ``bytes_limit``, the JAX keys) from ``torch.cuda.memory_stats`` and the
  per-process limit the HBM quota set.

PyTorch runs eagerly, so there is no jit cache to watch: the summary's
``jit_recompiles`` is None, not a count.

Records are JSONL tagged with the propagated ``ELASTIC_TPU_TRACE_ID``; the
file rotates to ``<path>.1`` past ``max_bytes``, and an in-memory ring
keeps the newest records for the end-of-run summary. Everything is
best-effort: a broken disk must not fail a train step.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from .contract import FlightSummarySubdir, UsageReportSubdir

logger = logging.getLogger(__name__)

ENV_TRACE_ID = "ELASTIC_TPU_TRACE_ID"
ENV_RECORDER_PATH = "ELASTIC_TPU_FLIGHT_RECORDER"

DEFAULT_MAX_BYTES = 4 * 1024 * 1024
DEFAULT_MEMORY_RECORDS = 512


def device_memory_stats(device=None) -> Optional[dict]:
    """bytes_in_use/peak/limit of a CUDA device (default: the current
    one); None for a CPU device or without a card. ``bytes_limit`` is the
    card's memory times the per-process fraction. Never raises."""
    try:
        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        dev = torch.device(device) if device is not None else torch.device(
            "cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
        get_frac = getattr(torch.cuda, "get_per_process_memory_fraction",
                           None)
        frac = get_frac(dev) if get_frac is not None else 1.0
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total * frac),
        }
    except Exception:  # noqa: BLE001 - telemetry, never load-bearing
        return None


class StepTimer:
    """Context manager timing one step; created by FlightRecorder.step."""

    def __init__(self, recorder: "FlightRecorder", step: int,
                 tokens: Optional[int], attrs: Dict) -> None:
        self._recorder = recorder
        self.step = step
        self.tokens = tokens
        self.attrs = dict(attrs)
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self._t0
        fields = {"step": self.step, "duration_ms": round(dt * 1000, 3)}
        if self.tokens is not None and dt > 0:
            fields["tokens"] = self.tokens
            fields["tokens_per_s"] = round(self.tokens / dt, 3)
        mem = device_memory_stats(self._recorder.device)
        if mem:
            fields["device_memory"] = mem
        if exc is not None:
            fields["error"] = f"{type(exc).__name__}: {exc}"
        fields.update(self.attrs)
        self._recorder.record("step", **fields)
        # never suppress the exception


class FlightRecorder:
    """Bounded JSONL step recorder, correlated to the agent's trace id.

    ``path`` None/"" -> in-memory only (the ring still feeds summary()).
    ``device``: the device whose memory each step record carries (None:
    the current CUDA device, if any).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        trace_id: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        max_memory_records: int = DEFAULT_MEMORY_RECORDS,
        device=None,
    ) -> None:
        self.trace_id = (
            trace_id if trace_id is not None
            else os.environ.get(ENV_TRACE_ID, "")
        )
        self.path = (
            path if path is not None
            else os.environ.get(ENV_RECORDER_PATH, "")
        )
        self.max_bytes = max_bytes
        self.device = device
        self.records: "deque[dict]" = deque(maxlen=max_memory_records)
        self._lock = threading.Lock()
        self._file = None
        self._file_broken = False
        self.written = 0  # lines that reached the file
        if self.path:
            self._open_file()

    # -- file plumbing --------------------------------------------------------

    def _open_file(self) -> None:
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._file = open(self.path, "a")
        except OSError as e:
            self._file = None
            self._file_broken = True
            logger.warning(
                "flight recorder: cannot open %s (%s); recording "
                "in-memory only", self.path, e,
            )

    def _rotate_locked(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass
        mode = "w"
        try:
            os.replace(self.path, self.path + ".1")
        except OSError as e:
            # rotation failed: reopen for append, since truncating now
            # would destroy the newest records
            mode = "a"
            if not self._file_broken:
                logger.warning(
                    "flight recorder: rotating %s failed (%s); "
                    "continuing unrotated", self.path, e,
                )
        try:
            self._file = open(self.path, mode)
        except OSError:
            self._file = None
            self._file_broken = True

    # -- recording ------------------------------------------------------------

    def record(self, kind: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 3), "kind": kind}
        if self.trace_id:
            rec["trace_id"] = self.trace_id
        rec.update(fields)
        with self._lock:
            self.records.append(rec)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(rec) + "\n")
                    self._file.flush()
                    self.written += 1
                    if self._file.tell() > self.max_bytes:
                        self._rotate_locked()
                except (OSError, ValueError):
                    # ValueError: write on a closed file after close()
                    if not self._file_broken:
                        self._file_broken = True
                        logger.warning(
                            "flight recorder: write to %s failed; "
                            "continuing in-memory only", self.path,
                        )
                    self._file = None
        return rec

    def step(self, step: int, tokens: Optional[int] = None,
             **attrs) -> StepTimer:
        """``with recorder.step(i, tokens=n): train_step(...)``"""
        return StepTimer(self, step, tokens, attrs)

    # -- reading --------------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            steps = [r for r in self.records if r.get("kind") == "step"]
            n = len(self.records)
        out = {
            "trace_id": self.trace_id,
            "path": self.path or None,
            "records": n,
            "steps": len(steps),
        }
        if steps:
            durs = [r["duration_ms"] for r in steps if "duration_ms" in r]
            if durs:
                out["mean_step_ms"] = round(sum(durs) / len(durs), 3)
            out["jit_recompiles"] = None   # eager: nothing is compiled
            rates = [r["tokens_per_s"] for r in steps if "tokens_per_s" in r]
            if rates:
                out["mean_tokens_per_s"] = round(
                    sum(rates) / len(rates), 3
                )
        out.update(self._serving_summary())
        return out

    def _serving_summary(self) -> dict:
        """The serving engine's records, summarised as the JAX recorder
        does: the prefix cache's economics over ``serving_admit`` records
        and, over the observatory's ``request_finish`` records, TTFT and
        TPOT p50/p99 per SLO class."""
        with self._lock:
            admits = [r for r in self.records
                      if r.get("kind") == "serving_admit"]
            finishes = [r for r in self.records
                        if r.get("kind") == "request_finish"]
        out = {}
        if admits:
            out["serving_admits"] = len(admits)
            flagged = [r for r in admits if "prefix_cache_hit" in r]
            if flagged:
                hits = sum(1 for r in flagged if r["prefix_cache_hit"])
                out["prefix_cache_hit_rate"] = round(hits / len(flagged), 3)
                out["prefix_cache_tokens_saved"] = sum(
                    r.get("cached_tokens", 0) for r in flagged
                )
        if finishes:
            def q(vals, frac):
                vs = sorted(vals)
                return round(vs[min(len(vs) - 1,
                                    int(round(frac * (len(vs) - 1))))], 3)

            classes = {}
            for r in finishes:
                classes.setdefault(r.get("slo", "batch"), []).append(r)
            rollup = {}
            for slo, recs in sorted(classes.items()):
                entry = {"finished": len(recs)}
                for key in ("ttft", "tpot"):
                    vals = [r[f"{key}_ms"] for r in recs
                            if r.get(f"{key}_ms") is not None]
                    if vals:
                        entry[f"{key}_p50_ms"] = q(vals, 0.5)
                        entry[f"{key}_p99_ms"] = q(vals, 0.99)
                rollup[slo] = entry
            out["request_finishes"] = len(finishes)
            out["request_slo"] = rollup
        return out

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                with contextlib.suppress(OSError):
                    self._file.close()
                self._file = None


def load_jsonl(path: str) -> List[dict]:
    """Read back a recorder file (rotated generation first, so records
    come out oldest to newest); tolerates a torn final line."""
    out: List[dict] = []
    for p in (path + ".1", path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out


def _write_sidecar(alloc_spec_dir: str, subdir: str, alloc_hash: str,
                   payload: dict) -> bool:
    """Atomic ``<alloc dir>/<subdir>/<hash>.json`` (fixed temp name +
    rename: one writer per hash, so crash debris is reclaimed by the next
    write); never raises."""
    d = os.path.join(alloc_spec_dir, subdir)
    path = os.path.join(d, f"{alloc_hash}.json")
    tmp = f"{path}.tmp"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def write_flight_summary(
    alloc_spec_dir: str,
    alloc_hash: str,
    tokens_per_s: float,
    steps: int = 0,
    mean_step_ms: Optional[float] = None,
    ttft_p50_s: Optional[float] = None,
    ts: float = None,
) -> bool:
    """Publish a flight-recorder summary to the node agent:
    ``<alloc dir>/flight/<alloc hash>.json`` with the latest achieved
    tokens/s (and, for serving pods, the median TTFT), which the agent's
    sampler exports per pod. True when it landed."""
    payload = {
        "ts": time.time() if ts is None else ts,
        "tokens_per_s": float(tokens_per_s),
        "steps": int(steps),
    }
    if mean_step_ms is not None:
        payload["mean_step_ms"] = float(mean_step_ms)
    if ttft_p50_s is not None:
        payload["ttft_p50_s"] = float(ttft_p50_s)
    return _write_sidecar(
        alloc_spec_dir, FlightSummarySubdir, alloc_hash, payload
    )


def write_usage_report(
    alloc_spec_dir: str,
    alloc_hash: str,
    duty_cycle_percent: float,
    hbm_used_bytes: int = 0,
    ts: float = None,
) -> bool:
    """Publish this workload's measured utilization to the node agent
    (``<alloc dir>/usage/<alloc hash>.json``: {"ts",
    "duty_cycle_percent", "hbm_used_bytes"}), the cooperative half of the
    agent's repartition contract. True when it landed."""
    return _write_sidecar(alloc_spec_dir, UsageReportSubdir, alloc_hash, {
        "ts": time.time() if ts is None else ts,
        "duty_cycle_percent": float(duty_cycle_percent),
        "hbm_used_bytes": int(hbm_used_bytes),
    })
