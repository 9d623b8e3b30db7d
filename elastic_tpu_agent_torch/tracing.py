"""Dependency-free allocation-lifecycle tracing.

The port's copy of ``elastic_tpu_agent/tracing.py``: every
allocation-path entry point (Allocate, PreStartContainer, the GC sweep,
``restore()``, a reconcile pass) opens a **trace**, a correlation id and
an ordered list of named, timed **spans**, and the layers it crosses (the
locator, storage, the bind's phases) attach spans through a contextvar,
with no plumbing. Completed traces land in a bounded ring (``dump()``
reads it), and PreStart stamps the bind's trace id into the spec env
(``ELASTIC_TPU_TRACE_ID``), which the in-pod flight recorder
(``workloads/telemetry.py``) tags its step records with. ``/debug/traces``
(metrics.py) serves the ring; the latency observatory listens for
completed traces and the timeline for slow spans (``add_listener``,
``add_slow_span_listener``); ``ring_bytes`` feeds the ring's memory
gauge.

Design constraints:
- **Zero dependencies** (stdlib only): the tracer must import in the
  agent container, the test rig, and workload images alike.
- **Never load-bearing**: tracing failures must not fail a bind. Spans
  opened with no active trace are recorded nowhere and cost two
  monotonic reads.
- **Thread-confined mutation**: a Trace is only ever mutated by the
  thread that opened it (contextvars are per-thread in the gRPC
  worker pool), so Trace/Span need no locks; only the shared ring
  append takes one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_current_trace: "ContextVar[Optional[Trace]]" = ContextVar(
    "elastic_tpu_trace", default=None
)

DEFAULT_CAPACITY = 256
# Spans slower than this are logged at WARNING with their trace id so a
# stalling layer (apiserver List, wedged /dev) is visible in the agent
# log even before anyone pulls /debug/traces.
DEFAULT_SLOW_SPAN_S = 0.25


def new_trace_id() -> str:
    """16 hex chars; collision odds are irrelevant at ring-buffer scale."""
    return os.urandom(8).hex()


class Span:
    """One named, timed section inside a trace."""

    __slots__ = ("name", "attrs", "error", "_t0", "offset_s", "duration_s")

    def __init__(self, name: str, offset_s: float, **attrs) -> None:
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs)
        self.error: Optional[str] = None
        self._t0 = time.monotonic()
        self.offset_s = offset_s
        self.duration_s = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _finish(self) -> None:
        self.duration_s = time.monotonic() - self._t0

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "offset_ms": round(self.offset_s * 1000, 3),
            "duration_ms": round(self.duration_s * 1000, 3),
            "attrs": dict(self.attrs),
        }
        if self.error is not None:
            out["error"] = self.error
        return out


class Trace:
    """A correlation id plus the ordered spans recorded under it."""

    __slots__ = (
        "trace_id", "name", "attrs", "spans", "error",
        "start_ts", "_t0", "duration_s", "_discarded",
    )

    def __init__(self, name: str, **attrs) -> None:
        self.trace_id = new_trace_id()
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs)
        self.spans: List[Span] = []
        self.error: Optional[str] = None
        self.start_ts = time.time()
        self._t0 = time.monotonic()
        self.duration_s = 0.0
        self._discarded = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def discard(self) -> None:
        """Drop this trace at finish instead of recording it — used by
        periodic sweeps (GC tick) whose no-op passes would otherwise
        churn useful traces out of the bounded ring."""
        self._discarded = True

    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def to_dict(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "name": self.name,
            "start_ts": self.start_ts,
            "duration_ms": round(self.duration_s * 1000, 3),
            "attrs": dict(self.attrs),
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.error is not None:
            out["error"] = self.error
        return out


class Tracer:
    """Ring buffer of completed traces + the contextvar plumbing."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        slow_span_s: float = DEFAULT_SLOW_SPAN_S,
    ) -> None:
        self.capacity = capacity
        self.slow_span_s = slow_span_s
        self._ring: "deque[Trace]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.completed = 0  # lifetime count (ring only keeps the newest)
        # Completed-trace listeners (latency observatory) and slow-span
        # listeners (timeline slow_span events). Both fire on the
        # recording thread and must never break it — failures are
        # swallowed at WARNING. Lists, not sets: registration order is
        # deterministic and callables need not be hashable.
        self._listeners: List = []
        self._slow_span_listeners: List = []

    def add_listener(self, fn) -> None:
        """Register ``fn(trace)``, called after every non-discarded
        trace lands in the ring."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def add_slow_span_listener(self, fn) -> None:
        """Register ``fn(trace, span)``, called when a span under an
        active trace exceeds ``slow_span_s``."""
        with self._lock:
            if fn not in self._slow_span_listeners:
                self._slow_span_listeners.append(fn)

    def remove_slow_span_listener(self, fn) -> None:
        with self._lock:
            if fn in self._slow_span_listeners:
                self._slow_span_listeners.remove(fn)

    def ring_bytes(self, sample: int = 16) -> int:
        """Approximate bytes held by the trace ring: the JSON-encoded
        size of the newest ``sample`` traces extrapolated over the ring
        length. An estimate by design — exact accounting would
        serialize every trace on every scrape; this is the bounded-
        memory gauge (elastic_tpu_trace_ring_bytes) the scale harness
        asserts a ceiling against, not a byte-exact ledger."""
        import json

        with self._lock:
            n = len(self._ring)
            if n == 0:
                return 0
            newest = [self._ring[-1 - i] for i in range(min(n, sample))]
        sampled = 0
        counted = 0
        for tr in newest:
            try:
                sampled += len(json.dumps(tr.to_dict(), default=str))
                counted += 1
            except Exception:  # noqa: BLE001 - estimate must not raise
                continue
        if not counted:
            return 0
        return int(sampled / counted * n)

    # -- recording ------------------------------------------------------------

    @contextlib.contextmanager
    def trace(self, name: str, **attrs):
        """Open a trace for the duration of the block; it becomes the
        thread's current trace (span()/annotate() attach to it). An
        exception is recorded on the trace and re-raised; the trace is
        kept — a FAILED bind is exactly the trace someone will want."""
        tr = Trace(name, **attrs)
        token = _current_trace.set(tr)
        try:
            yield tr
        except BaseException as e:
            tr.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _current_trace.reset(token)
            tr.duration_s = tr.elapsed_s()
            if not tr._discarded:
                with self._lock:
                    self._ring.append(tr)
                    self.completed += 1
                    listeners = list(self._listeners)
                for fn in listeners:
                    try:
                        fn(tr)
                    except Exception:  # noqa: BLE001 - never load-bearing
                        logger.warning(
                            "trace listener %r failed", fn, exc_info=True
                        )

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a named span under the current trace; a no-op (but
        still yields a settable Span) when no trace is active, so
        instrumented layers never need to know whether they are inside
        a traced request."""
        tr = _current_trace.get()
        sp = Span(name, tr.elapsed_s() if tr is not None else 0.0, **attrs)
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            sp._finish()
            if tr is not None:
                tr.spans.append(sp)
                if sp.duration_s >= self.slow_span_s:
                    logger.warning(
                        "slow span %s (%.1f ms) in trace %s (%s)%s",
                        sp.name, sp.duration_s * 1000, tr.trace_id,
                        tr.name,
                        f": {sp.error}" if sp.error else "",
                    )
                    with self._lock:
                        listeners = list(self._slow_span_listeners)
                    for fn in listeners:
                        try:
                            fn(tr, sp)
                        except Exception:  # noqa: BLE001
                            logger.warning(
                                "slow-span listener %r failed",
                                fn, exc_info=True,
                            )

    def current(self) -> Optional[Trace]:
        return _current_trace.get()

    def current_id(self) -> str:
        tr = _current_trace.get()
        return tr.trace_id if tr is not None else ""

    def annotate(self, **attrs) -> None:
        """Attach attributes to the current trace, if any."""
        tr = _current_trace.get()
        if tr is not None:
            tr.set(**attrs)

    def annotate_pod(self, pod: str) -> None:
        """Mark the current trace as involving ``pod``. Unlike a plain
        annotate(pod=...), repeat calls ACCUMULATE — a GC sweep that
        reclaims several pods must be findable under each of them."""
        tr = _current_trace.get()
        if tr is None:
            return
        pods = tr.attrs.setdefault("pods", [])
        if pod not in pods:
            pods.append(pod)

    def adopt_id(self, trace_id: str) -> None:
        """Adopt an externally-assigned correlation id for the current
        trace (cross-component continuity: the scheduler/admission side
        stamps ``elasticgpu.io/trace-id`` on the pod, and the agent that
        ends up binding it continues under the SAME id, so one string
        follows the pod from apiserver admission to whichever node bound
        it). The locally-generated id is preserved as an attribute for
        log-line correlation."""
        tr = _current_trace.get()
        if tr is None or not trace_id or tr.trace_id == trace_id:
            return
        tr.attrs.setdefault("local_trace_id", tr.trace_id)
        tr.trace_id = trace_id

    # -- reading --------------------------------------------------------------

    def dump(
        self,
        pod: Optional[str] = None,
        limit: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> List[dict]:
        """Completed traces, newest first; ``pod`` filters on the
        trace's pod attribute (exact "ns/name" or bare pod name);
        ``trace_id`` filters on the exact correlation id (the fleet
        aggregator's continuity lookup)."""
        with self._lock:
            traces = list(self._ring)
        traces.reverse()
        out = []
        for tr in traces:
            if limit is not None and len(out) >= limit:
                break
            if trace_id and tr.trace_id != trace_id:
                continue
            if pod:
                candidates = [str(tr.attrs.get("pod", ""))]
                candidates.extend(
                    str(p) for p in tr.attrs.get("pods", []) or []
                )
                if not any(
                    c == pod or c.rpartition("/")[2] == pod
                    for c in candidates if c
                ):
                    continue
            out.append(tr.to_dict())
        return out


def _default_tracer() -> Tracer:
    slow_ms = os.environ.get("ELASTIC_TPU_SLOW_SPAN_MS", "")
    try:
        slow_s = float(slow_ms) / 1000 if slow_ms else DEFAULT_SLOW_SPAN_S
    except ValueError:
        slow_s = DEFAULT_SLOW_SPAN_S
    return Tracer(slow_span_s=slow_s)


_tracer = _default_tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every layer records into. One agent
    process serves one node, so a single ring is the right scope; tests
    swap it with set_tracer() for isolation."""
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev
