"""Critical-path latency observatory and detection-lag accounting.

The port's copy of ``elastic_tpu_agent/latency.py``; both ledgers are
dependency-free and bounded:

- :class:`BindLatencyObservatory` turns completed bind traces
  (tracing.py) into a **per-phase breakdown** of where the milliseconds
  go (lock wait, kubelet List, storage sync-flush wait, spec write, sink
  enqueue, link creation), exported as
  ``elastic_tpu_bind_phase_seconds{phase}`` with a per-bucket **trace-id
  exemplar table**, so that a slow bucket resolves to a trace in
  ``/debug/traces``. An ``unattributed`` residual absorbs whatever the
  spans did not cover, so ``sum(phases) + residual == measured total`` by
  construction, and the residual's share says how much is unexplained.
- :class:`DetectionLagTracker` accounts **origin -> detection -> repair**
  latency for the polled loops the port runs (the reconciler, and GC from
  the sitter's deletion mark). Surfaced as
  ``elastic_tpu_detection_lag_seconds{loop,stage,trigger}``; ``trigger``
  says what woke the observing pass (``event`` = the bus or the sitter's
  deletion queue, ``poll`` = the periodic sweep).

Constraints (as tracing.py): stdlib only; never load-bearing (every
public entry point swallows its own failures); bounded memory.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# -- phase vocabulary ----------------------------------------------------------

# The closed phase vocabulary of the bind critical path. Order is the
# rough order phases occur in a bind; "unattributed" is the residual.
PHASE_LOCK_WAIT = "lock_wait"
PHASE_KUBELET_LIST = "kubelet_list"
PHASE_STORAGE_SYNC = "storage_sync"
PHASE_SPEC_WRITE = "spec_write"
PHASE_SINK_ENQUEUE = "sink_enqueue"
PHASE_SIDECAR = "sidecar"
PHASE_UNATTRIBUTED = "unattributed"

PHASES = (
    PHASE_LOCK_WAIT,
    PHASE_KUBELET_LIST,
    PHASE_STORAGE_SYNC,
    PHASE_SPEC_WRITE,
    PHASE_SINK_ENQUEUE,
    PHASE_SIDECAR,
)

# span name (tracing.py call sites) -> phase. Nested spans that map to
# the SAME phase (checkpoint wrapping storage_flush_wait) never double
# count: attribution claims time intervals innermost-first.
SPAN_PHASE = {
    "bind_lock_wait": PHASE_LOCK_WAIT,
    "pod_lookup": PHASE_KUBELET_LIST,
    "pod_resources_list": PHASE_KUBELET_LIST,
    "prefetch_locator": PHASE_KUBELET_LIST,
    # the locator's assignment lookup: kubelet pod-resources snapshot
    # reads + refresh waits — the dominant bind phase under churn
    "locator_locate": PHASE_KUBELET_LIST,
    "operator_create": PHASE_SIDECAR,
    "checkpoint": PHASE_STORAGE_SYNC,
    "storage_flush_wait": PHASE_STORAGE_SYNC,
    "write_alloc_spec": PHASE_SPEC_WRITE,
    "sink_enqueue": PHASE_SINK_ENQUEUE,
    "materialize_nodes": PHASE_SIDECAR,
}

# Exemplar bucket bounds — the same vocabulary as the
# elastic_tpu_bind_phase_seconds histogram (metrics._BUCKETS), kept
# here too so the observatory stays importable without prometheus.
EXEMPLAR_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, math.inf,
)

DEFAULT_RECENT_CAP = 512
DEFAULT_SLOW_CAP = 32


def _quantile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile over a small sample (no interpolation —
    these windows are a few hundred points, exactness is not the
    point)."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def _bucket_le(seconds: float) -> float:
    for le in EXEMPLAR_BUCKETS:
        if seconds <= le:
            return le
    return math.inf


def attribute_spans(spans) -> Dict[str, float]:
    """Attribute a trace's span intervals to phases, innermost-first.

    Each span is an interval ``[offset, offset + duration)`` on the
    trace's own clock. Spans are processed shortest-first, and a span's
    contribution is its interval MINUS whatever shorter (nested) spans
    already claimed — so ``checkpoint`` wrapping ``storage_flush_wait``
    contributes only its unclaimed remainder, and the phase sums can
    never exceed wall time regardless of how call sites nest.

    ``spans`` is an iterable of objects with ``name``, ``offset_s`` and
    ``duration_s`` (tracing.Span) or dicts with ``name``/``offset_ms``/
    ``duration_ms`` (a serialized trace). Returns phase -> seconds for
    phases that claimed any time.
    """
    intervals = []
    for sp in spans:
        if isinstance(sp, dict):
            name = sp.get("name", "")
            start = float(sp.get("offset_ms", 0.0)) / 1000.0
            dur = float(sp.get("duration_ms", 0.0)) / 1000.0
        else:
            name = sp.name
            start = float(sp.offset_s)
            dur = float(sp.duration_s)
        phase = SPAN_PHASE.get(name)
        if phase is None or dur <= 0:
            continue
        intervals.append((dur, start, start + dur, phase))
    intervals.sort()  # shortest (innermost) first
    claimed: List[tuple] = []  # disjoint (start, end) already attributed
    out: Dict[str, float] = {}
    for dur, start, end, phase in intervals:
        remaining = [(start, end)]
        for c0, c1 in claimed:
            nxt = []
            for s0, s1 in remaining:
                if c1 <= s0 or c0 >= s1:  # no overlap
                    nxt.append((s0, s1))
                    continue
                if s0 < c0:
                    nxt.append((s0, c0))
                if c1 < s1:
                    nxt.append((c1, s1))
            remaining = nxt
            if not remaining:
                break
        got = sum(s1 - s0 for s0, s1 in remaining)
        if got > 0:
            out[phase] = out.get(phase, 0.0) + got
            claimed.extend(remaining)
            claimed.sort()
    return out


class BindLatencyObservatory:
    """Per-phase breakdown of completed bind traces, with bucket
    exemplars, a top-N slowest table and the unattributed residual.

    Registered as a tracer listener (tracing.Tracer.add_listener); in
    a simulated fleet many agents share one process-wide tracer, so the
    observatory filters on the trace's ``node`` attribute when given a
    node name.
    """

    def __init__(
        self,
        metrics=None,
        node_name: str = "",
        trace_name: str = "PreStartContainer",
        recent_cap: int = DEFAULT_RECENT_CAP,
        slow_cap: int = DEFAULT_SLOW_CAP,
    ) -> None:
        self._metrics = metrics
        self._node = node_name
        self._trace_name = trace_name
        self._lock = threading.Lock()
        self._recent: "deque[dict]" = deque(maxlen=max(8, recent_cap))
        self._slow_cap = max(1, slow_cap)
        # phase -> le -> {"trace_id", "ms"}: the newest trace observed
        # in each bucket, so every populated bucket stays resolvable to
        # a concrete trace in /debug/traces.
        self._exemplars: Dict[str, Dict[float, dict]] = {}
        self.observed_total = 0

    # -- recording (tracer listener) ------------------------------------------

    def observe_trace(self, trace) -> None:
        """Tracer listener entry point: never raises."""
        try:
            self._observe(trace)
        except Exception:  # noqa: BLE001 - observatory never breaks a bind
            logger.exception("bind latency attribution failed")

    def _observe(self, trace) -> None:
        if trace.name != self._trace_name or trace.error is not None:
            return
        node = str(trace.attrs.get("node", ""))
        if self._node and node and node != self._node:
            return  # another sim agent's bind on the shared tracer
        total = float(trace.duration_s)
        if total <= 0:
            return
        phases = attribute_spans(trace.spans)
        residual = max(0.0, total - sum(phases.values()))
        pod = str(
            trace.attrs.get("pod", "")
            or ((trace.attrs.get("pods") or [""]) or [""])[0]
        )
        entry = {
            "trace_id": trace.trace_id,
            "ts": trace.start_ts,
            "pod": pod,
            "total_ms": round(total * 1000, 3),
            "phases_ms": {
                p: round(s * 1000, 3) for p, s in sorted(phases.items())
            },
            "residual_ms": round(residual * 1000, 3),
            "dominant_phase": (
                max(phases, key=phases.get) if phases
                and max(phases.values()) >= residual else PHASE_UNATTRIBUTED
            ),
        }
        with self._lock:
            self.observed_total += 1
            self._recent.append(entry)
            for phase, seconds in phases.items():
                self._exemplars.setdefault(phase, {})[
                    _bucket_le(seconds)
                ] = {"trace_id": trace.trace_id,
                     "ms": round(seconds * 1000, 3)}
            self._exemplars.setdefault(PHASE_UNATTRIBUTED, {})[
                _bucket_le(residual)
            ] = {"trace_id": trace.trace_id,
                 "ms": round(residual * 1000, 3)}
        m = self._metrics
        if m is not None and hasattr(m, "bind_phase_seconds"):
            try:
                for phase, seconds in phases.items():
                    m.bind_phase_seconds.labels(phase=phase).observe(seconds)
                m.bind_phase_seconds.labels(
                    phase=PHASE_UNATTRIBUTED
                ).observe(residual)
            except Exception:  # noqa: BLE001 - metrics never break a bind
                pass

    # -- reading --------------------------------------------------------------

    def status(self, top: Optional[int] = None) -> dict:
        """The /debug/latency "bind" block: per-phase p50/p99 + share of
        total, bucket exemplars, top-N slowest recent traces with their
        dominant phase, and the residual's share (the checkability
        contract: phase sums + residual == measured totals)."""
        top = self._slow_cap if top is None else max(1, top)
        with self._lock:
            recent = list(self._recent)
            exemplars = {
                phase: {
                    ("+Inf" if math.isinf(le) else le): dict(ex)
                    for le, ex in sorted(buckets.items())
                }
                for phase, buckets in self._exemplars.items()
            }
            observed = self.observed_total
        totals = [e["total_ms"] for e in recent]
        sum_total = sum(totals)
        phase_block: Dict[str, dict] = {}
        for phase in (*PHASES, PHASE_UNATTRIBUTED):
            values = [
                e["residual_ms"] if phase == PHASE_UNATTRIBUTED
                else e["phases_ms"].get(phase, 0.0)
                for e in recent
            ]
            nonzero = [v for v in values if v > 0]
            phase_sum = sum(values)
            phase_block[phase] = {
                "count": len(nonzero),
                "p50_ms": _quantile(values, 0.5),
                "p99_ms": _quantile(values, 0.99),
                "share_of_total": (
                    round(phase_sum / sum_total, 4) if sum_total else None
                ),
                "exemplars": exemplars.get(phase, {}),
            }
        slowest = sorted(
            recent, key=lambda e: e["total_ms"], reverse=True
        )[:top]
        return {
            "observed_total": observed,
            "window": len(recent),
            "total_p50_ms": _quantile(totals, 0.5),
            "total_p99_ms": _quantile(totals, 0.99),
            "phases": phase_block,
            "residual_share": phase_block[PHASE_UNATTRIBUTED][
                "share_of_total"
            ],
            "slowest": slowest,
        }


# -- detection-lag accounting --------------------------------------------------

STAGE_DETECT = "detect"
STAGE_REPAIR = "repair"

# Bound on stored origin marks and dedup entries: divergences are rare
# and repairs pop their marks, so hitting this means a test rig leaked.
DEFAULT_MAX_MARKS = 4096
DEFAULT_RECENT_PER_CLASS = 128


class DetectionLagTracker:
    """Origin -> detection -> repair latency, per polled loop.

    - :meth:`mark` stamps a divergence origin (``cls``/``key``) — the
      seam fault injectors, a simulated fleet and tests use; loops whose
      origins ride in file payloads (usage reports, checkpoint acks)
      or operator injections pass ``origin_ts`` directly instead.
    - :meth:`repaired` observes the repair stage; :meth:`handled`
      observes detection and repair at once (loops whose detection IS
      the repair: a reconciler pass, a GC sweep).

    Clock-skew and restart semantics (pinned by tests):
    - a negative lag (origin stamped by a skewed clock) is clamped to
      0 and counted in ``clamped_total`` — never exported negative;
    - an observation with no known origin returns None and records
      nothing: after an agent restart (fresh tracker) a re-detected
      pre-restart divergence contributes no bogus lag;
    - repairs pop their mark, and the same (loop, stage, class, key,
      origin) is observed at most once — re-reading a still-on-disk
      origin (ack file, usage report) cannot double count.
    """

    def __init__(
        self,
        metrics=None,
        clock=None,
        recent_per_class: int = DEFAULT_RECENT_PER_CLASS,
        max_marks: int = DEFAULT_MAX_MARKS,
    ) -> None:
        from .common import SYSTEM_CLOCK

        self._metrics = metrics
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._marks: "OrderedDict[tuple, float]" = OrderedDict()
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()
        self._max = max(16, max_marks)
        self._recent_cap = max(8, recent_per_class)
        # class -> deque of {"lag_s", "loop", "ts"} (repair stage only:
        # a fleet rollup reports origin->repair per divergence class)
        self._recent: Dict[str, deque] = {}
        self.clamped_total = 0
        self.observations = {STAGE_DETECT: 0, STAGE_REPAIR: 0}

    # -- origin stamping ------------------------------------------------------

    def mark(self, cls: str, key: str = "", ts: Optional[float] = None) -> None:
        """Stamp a divergence origin. Idempotent per (cls, key): the
        FIRST stamp wins (re-asserting a still-unrepaired fault must
        not shrink its measured lag)."""
        try:
            with self._lock:
                k = (str(cls), str(key))
                if k not in self._marks:
                    self._marks[k] = (
                        self._clock.time() if ts is None else float(ts)
                    )
                    while len(self._marks) > self._max:
                        self._marks.popitem(last=False)
        except Exception:  # noqa: BLE001 - accounting never breaks a caller
            logger.exception("detection-lag mark failed")

    # -- observations ---------------------------------------------------------

    def detected(
        self, loop: str, cls: str, key: str = "",
        origin_ts: Optional[float] = None, trigger: str = "poll",
    ) -> Optional[float]:
        """Detection alone (the drain's maintenance and preemption
        triggers): the mark stays for the repair that follows."""
        return self._observe(loop, STAGE_DETECT, cls, key, origin_ts,
                             clear=False, trigger=trigger)

    def repaired(
        self, loop: str, cls: str, key: str = "",
        origin_ts: Optional[float] = None, trigger: str = "poll",
    ) -> Optional[float]:
        return self._observe(loop, STAGE_REPAIR, cls, key, origin_ts,
                             clear=True, trigger=trigger)

    def handled(
        self, loop: str, cls: str, key: str = "",
        origin_ts: Optional[float] = None, trigger: str = "poll",
    ) -> Optional[float]:
        """Detection and repair collapsed into one call — for loops
        whose single pass both notices and resolves the divergence.
        ``trigger`` records what woke the pass ("event" = targeted
        event-bus pass, "poll" = the periodic sweep) so event-vs-poll
        lag is directly comparable per loop."""
        self._observe(loop, STAGE_DETECT, cls, key, origin_ts, clear=False,
                      trigger=trigger)
        return self._observe(loop, STAGE_REPAIR, cls, key, origin_ts,
                             clear=True, trigger=trigger)

    def _observe(
        self, loop: str, stage: str, cls: str, key: str,
        origin_ts: Optional[float], clear: bool, trigger: str = "poll",
    ) -> Optional[float]:
        try:
            cls, key = str(cls), str(key)
            now = self._clock.time()
            with self._lock:
                origin = (
                    float(origin_ts) if origin_ts is not None
                    else self._marks.get((cls, key))
                )
                if origin is None:
                    return None
                dedup = (str(loop), stage, cls, key, origin)
                if dedup in self._seen:
                    return None  # same origin already observed: no recount
                self._seen[dedup] = None
                while len(self._seen) > self._max:
                    self._seen.popitem(last=False)
                lag = now - origin
                if lag < 0:
                    lag = 0.0
                    self.clamped_total += 1
                self.observations[stage] = (
                    self.observations.get(stage, 0) + 1
                )
                if clear:
                    self._marks.pop((cls, key), None)
                if stage == STAGE_REPAIR:
                    self._recent.setdefault(
                        cls, deque(maxlen=self._recent_cap)
                    ).append({
                        "lag_s": round(lag, 6), "loop": str(loop), "ts": now,
                        "trigger": str(trigger),
                    })
            m = self._metrics
            if m is not None and hasattr(m, "detection_lag"):
                try:
                    m.detection_lag.labels(
                        loop=str(loop), stage=stage, trigger=str(trigger)
                    ).observe(lag)
                    if lag == 0.0 and origin > now and hasattr(
                        m, "detection_lag_clamped"
                    ):
                        m.detection_lag_clamped.inc()
                except Exception:  # noqa: BLE001 - metrics never break repair
                    pass
            return lag
        except Exception:  # noqa: BLE001 - accounting never breaks a caller
            logger.exception("detection-lag observation failed")
            return None

    # -- reading --------------------------------------------------------------

    def status(self) -> dict:
        """The /debug/latency "detection_lag" block: per-class recent
        origin->repair lags with p50/p99 (what a fleet aggregator
        merges), plus the clamp counter and open-mark gauge."""
        with self._lock:
            classes = {
                cls: list(entries) for cls, entries in self._recent.items()
            }
            open_marks = len(self._marks)
            clamped = self.clamped_total
            observations = dict(self.observations)
        block = {}
        for cls, entries in sorted(classes.items()):
            lags = [e["lag_s"] for e in entries]
            triggers: Dict[str, list] = {}
            for e in entries:
                triggers.setdefault(e.get("trigger", "poll"), []).append(
                    e["lag_s"]
                )
            block[cls] = {
                "count": len(lags),
                "p50_s": _quantile(lags, 0.5),
                "p99_s": _quantile(lags, 0.99),
                "max_s": max(lags) if lags else None,
                "loops": sorted({e["loop"] for e in entries}),
                # event-vs-poll comparability (satellite of the event
                # core): per-trigger count + p50 of the same class
                "triggers": {
                    t: {"count": len(ls), "p50_s": _quantile(ls, 0.5)}
                    for t, ls in sorted(triggers.items())
                },
                "recent": entries[-20:],
            }
        return {
            "classes": block,
            "open_marks": open_marks,
            "clamped_total": clamped,
            "observations": observations,
        }
