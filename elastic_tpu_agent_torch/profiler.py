"""Continuous in-process sampling profiler (dependency-free).

The port's copy of ``elastic_tpu_agent/profiler.py``. A wedged agent is
the one nobody can attach an external profiler to in time. This module
keeps a cheap statistical profile running INSIDE the agent: a supervised
loop walks ``sys._current_frames()`` a few times a second, aggregates the
frames into a bounded stack table, and serves it at ``/debug/profile``
(the metrics HTTP threads keep answering while the main loops are wedged)
and through ``node-doctor profile``.

Self-honesty contract: the profiler measures its own cost (time inside
:meth:`sample_once` over wall time) and exports it as
``elastic_tpu_profiler_overhead_ratio``; at 5 Hz (the agent's latency
smoke's rate) it must stay under 1%. Off (``--profile-hz 0``, the default)
it costs nothing.

Bounded by construction: at most ``max_stacks`` distinct aggregated
stacks (new stacks beyond the cap are counted dropped, never stored), at
most ``depth`` frames per stack.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

DEFAULT_MAX_STACKS = 256
DEFAULT_DEPTH = 24


class SamplingProfiler:
    """Supervised sampling profiler: ``run(stop)`` paces
    :meth:`sample_once` at ``hz``; ``status()`` is the read side."""

    def __init__(
        self,
        hz: float = 0.0,
        max_stacks: int = DEFAULT_MAX_STACKS,
        depth: int = DEFAULT_DEPTH,
    ) -> None:
        self.hz = max(0.0, float(hz))
        self.max_stacks = max(16, int(max_stacks))
        self.depth = max(2, int(depth))
        self._lock = threading.Lock()
        # (thread name, (frame, ...)) -> sample count, leaf-first frames
        # rendered "file.py:lineno:function"
        self._stacks: Dict[tuple, int] = {}
        self.samples_total = 0
        self.threads_seen = 0
        self.dropped_stacks = 0
        self._sampling_s = 0.0  # cumulative wall time spent sampling
        self._started_mono = time.monotonic()

    # -- sampling -------------------------------------------------------------

    def sample_once(self) -> int:
        """Walk every thread's current frame once; returns the number of
        threads sampled. The profiler's own thread is excluded (it
        would otherwise dominate its own profile with this walk)."""
        t0 = time.monotonic()
        own = threading.get_ident()
        try:
            frames = sys._current_frames()  # noqa: SLF001 - the whole point
            names = {
                t.ident: t.name for t in threading.enumerate()
                if t.ident is not None
            }
            sampled = 0
            aggregated = []
            for ident, frame in frames.items():
                if ident == own:
                    continue
                stack = []
                f = frame
                while f is not None and len(stack) < self.depth:
                    code = f.f_code
                    stack.append(
                        f"{code.co_filename.rsplit('/', 1)[-1]}"
                        f":{f.f_lineno}:{code.co_name}"
                    )
                    f = f.f_back
                aggregated.append(
                    (names.get(ident, f"tid-{ident}"), tuple(stack))
                )
                sampled += 1
            with self._lock:
                for key in aggregated:
                    if key in self._stacks:
                        self._stacks[key] += 1
                    elif len(self._stacks) < self.max_stacks:
                        self._stacks[key] = 1
                    else:
                        self.dropped_stacks += 1
                self.samples_total += 1
                self.threads_seen = max(self.threads_seen, sampled)
            return sampled
        finally:
            with self._lock:
                self._sampling_s += time.monotonic() - t0

    def run(self, stop: threading.Event) -> None:
        """Supervised loop (DEGRADED): a crashed profiler restarts with
        its table intact on the same instance; hz <= 0 parks until
        stop (registered only behind --profile-hz, but defensive)."""
        if self.hz <= 0:
            stop.wait()
            return
        period = 1.0 / self.hz
        while not stop.wait(period):
            self.sample_once()

    # -- reading --------------------------------------------------------------

    def overhead_ratio(self) -> float:
        """Fraction of wall time spent inside sample_once() since this
        profiler was constructed — the measured self-overhead gauge
        (the <=1% contract the smoke pins)."""
        wall = time.monotonic() - self._started_mono
        if wall <= 0:
            return 0.0
        with self._lock:
            return self._sampling_s / wall

    def status(self, top: int = 30) -> dict:
        """The /debug/profile payload: hottest aggregated stacks
        (leaf-first frames), sample/drop counters, measured overhead."""
        with self._lock:
            items = sorted(
                self._stacks.items(), key=lambda kv: kv[1], reverse=True
            )[:max(1, top)]
            samples = self.samples_total
            dropped = self.dropped_stacks
            unique = len(self._stacks)
            threads = self.threads_seen
        return {
            "enabled": self.hz > 0,
            "hz": self.hz,
            "samples_total": samples,
            "unique_stacks": unique,
            "dropped_stacks": dropped,
            "max_stacks": self.max_stacks,
            "threads_seen": threads,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "top": [
                {
                    "count": count,
                    "share": round(count / samples, 4) if samples else None,
                    "thread": thread,
                    "stack": list(stack),
                }
                for (thread, stack), count in items
            ],
        }


def render_profile(payload: dict, top: Optional[int] = None) -> str:
    """Human-readable rendering of a /debug/profile payload (the
    ``node-doctor profile`` output)."""
    lines = []
    if not payload.get("enabled"):
        lines.append(
            "profiler DISABLED (start the agent with --profile-hz > 0)"
        )
    lines.append(
        f"samples={payload.get('samples_total', 0)} "
        f"hz={payload.get('hz', 0)} "
        f"unique_stacks={payload.get('unique_stacks', 0)} "
        f"dropped={payload.get('dropped_stacks', 0)} "
        f"overhead={100.0 * (payload.get('overhead_ratio') or 0.0):.3f}%"
    )
    entries = payload.get("top", [])
    if top is not None:
        entries = entries[:max(1, top)]
    for entry in entries:
        share = entry.get("share")
        lines.append(
            f"{entry.get('count', 0):>7} "
            f"{('%5.1f%%' % (100 * share)) if share is not None else '    ?'} "
            f"[{entry.get('thread', '?')}]"
        )
        for frame in entry.get("stack", []):
            lines.append(f"          {frame}")
    return "\n".join(lines)
