"""k8s Event emission for the allocation lifecycle.

The port's copy of ``elastic_tpu_agent/kube/events.py``: binds, bind
failures, GC reclaims, reconciler repairs and restore sweeps surface as
Events on the involved Pod (or on this Node for podless actions), so that
``kubectl describe pod`` answers "why does my container (not) have its
card" without node access.

The reasons, the reporting component and the body's shape are the
agent's: they are what alerts and ``kubectl get events
--field-selector reason=...`` match on, and the agent's RBAC grants them.
The messages name the port's resources (``elasticgpu.io/gpu-core``,
``gpu-memory``) and cards.

Emission rides the shared AsyncSink: off the bind path, never raises,
self-disables when the apiserver persistently refuses it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from datetime import datetime, timezone
from typing import Dict, Optional, Tuple

from ..async_sink import AsyncSink, drop_hook, register_sink_metrics

logger = logging.getLogger(__name__)

COMPONENT = "elastic-tpu-agent"

# Client-side aggregation: identical events inside this window are folded
# into one object with a bumped count, so a crash-looping pod (kubelet
# retries PreStart on every restart backoff) cannot churn etcd with an
# unbounded TPUBindFailed stream.
AGGREGATION_WINDOW_S = 60.0
_MAX_TRACKED_KEYS = 1024

# apiserver rejects metadata.name > 253 chars; leave room for ".<16hex>".
_MAX_BASE_LEN = 253 - 17

# Reasons (CamelCase by k8s convention)
ReasonBound = "TPUBound"
ReasonBindFailed = "TPUBindFailed"
ReasonReclaimed = "TPUReclaimed"
ReasonRestored = "TPURestored"
ReasonReconciled = "TPUReconciled"
ReasonChipUnhealthy = "TPUChipUnhealthy"
ReasonChipHealthy = "TPUChipHealthy"
ReasonAllocatableDrift = "TPUAllocatableDrift"
# the drain lifecycle (drain.py)
ReasonMaintenanceImminent = "TPUMaintenanceImminent"
ReasonNodeDraining = "TPUNodeDraining"
ReasonNodeDrained = "TPUNodeDrained"
ReasonDrainCancelled = "TPUDrainCancelled"
# the migration handshake (migration.py): a resident's checkpoint verified
# durable and its record published; the replacement's resume verified
ReasonMigrationRecorded = "TPUMigrationRecorded"
ReasonMigrationCompleted = "TPUMigrationCompleted"
# live re-partitioning and QoS enforcement (repartition.py): a quota move,
# a throttle clamp, an eviction past the throttle
ReasonRepartitioned = "TPURepartitioned"
ReasonThrottled = "TPUThrottled"
ReasonQoSEvicted = "TPUQoSEvicted"
# slice orchestration (slices/): a member re-formed at a new world size,
# and a slice whose members derived inconsistent worlds
ReasonSliceReformed = "TPUSliceReformed"
ReasonSliceInconsistent = "TPUSliceInconsistent"


class EventRecorder:
    """Posts core/v1 Events; all methods non-blocking and never raise."""

    def __init__(
        self, kube_client, node_name: str, metrics=None,
        flush_window_s: float = 0.0,
    ) -> None:
        self._client = kube_client
        self._node = node_name
        self._sink = AsyncSink(
            "event-recorder", on_drop=drop_hook(metrics),
            flush_window_s=flush_window_s,
        )
        register_sink_metrics(self._sink, metrics)
        # key -> (last_emit_monotonic, suppressed_since_then, emit_ctx)
        # where emit_ctx = (namespace, base, involved, reason, message, type_)
        # is kept so suppressed tails can be surfaced after the window.
        self._recent: Dict[Tuple, Tuple[float, int, Tuple]] = {}
        self._recent_lock = threading.Lock()
        self._stopped = threading.Event()
        # Without this sweeper, occurrences folded inside the window would
        # only surface on the NEXT post-window emission for the same key —
        # a storm that stops would lose its tail counts forever.
        self._sweeper = threading.Thread(
            target=self._sweep_loop, daemon=True, name="event-residuals"
        )
        self._sweeper.start()

    @property
    def disabled(self) -> bool:
        return self._sink.disabled

    def flush(self, timeout: float = 10.0) -> bool:
        return self._sink.flush(timeout=timeout)

    def run_supervised(self, stop) -> None:
        """Supervisor target (supervisor.py): watchdog over the sink's
        internal worker thread."""
        self._sink.run_supervised(stop)

    def stop(self, timeout: float = 30.0) -> None:
        # Generous default: the sink drains on stop (async_sink); a short
        # cap would abandon queued events at shutdown.
        self._stopped.set()
        # Join the sweeper BEFORE the force flush: a sweep that already
        # zeroed a suppressed count under the lock but hasn't posted it yet
        # would otherwise race the sink shutdown and drop the tail silently.
        self._sweeper.join(timeout=timeout)
        self.flush_residuals(force=True)
        self._sink.stop(timeout=timeout)

    def _sweep_loop(self) -> None:
        while not self._stopped.wait(AGGREGATION_WINDOW_S):
            try:
                self.flush_residuals()
            except Exception:  # noqa: BLE001 - observability must not wedge
                logger.exception("residual event sweep failed")

    def flush_residuals(self, force: bool = False) -> None:
        """Publish counts folded during aggregation windows that have since
        lapsed (or all pending counts when ``force``), so storm tails are
        surfaced even if the storm stopped before the next emission."""
        now = time.monotonic()
        due = []
        with self._recent_lock:
            for key, (last, suppressed, ctx) in list(self._recent.items()):
                if suppressed <= 0:
                    continue
                if force or now - last >= AGGREGATION_WINDOW_S:
                    due.append((suppressed, ctx))
                    self._recent[key] = (last, 0, ctx)
        for count, ctx in due:
            self._post(*ctx, count=count)

    # -- emitters -------------------------------------------------------------

    @staticmethod
    def _tag_trace(message: str, trace_id: str) -> str:
        """Suffix the allocation trace id so `kubectl describe pod`
        hands the operator the key into /debug/traces (tracing.py).
        Falls back to the caller's current trace when none is given."""
        if not trace_id:
            from ..tracing import get_tracer

            trace_id = get_tracer().current_id()
        return f"{message} [trace {trace_id}]" if trace_id else message

    def pod_event(
        self,
        namespace: str,
        pod: str,
        reason: str,
        message: str,
        type_: str = "Normal",
        uid: str = "",
        trace_id: str = "",
    ) -> None:
        involved = {
            "kind": "Pod",
            "apiVersion": "v1",
            "namespace": namespace,
            "name": pod,
        }
        if uid:
            involved["uid"] = uid
        self._emit(
            namespace, pod, involved, reason, message, type_,
            display=self._tag_trace(message, trace_id),
        )

    def node_event(
        self,
        reason: str,
        message: str,
        type_: str = "Normal",
        trace_id: str = "",
    ) -> None:
        involved = {"kind": "Node", "apiVersion": "v1", "name": self._node}
        self._emit(
            "default", self._node, involved, reason, message, type_,
            display=self._tag_trace(message, trace_id),
        )

    def _should_emit(self, key: Tuple, ctx: Tuple) -> int:
        """0 = suppress (inside the aggregation window); otherwise the
        count to publish (1 + occurrences folded since the last emit)."""
        now = time.monotonic()
        with self._recent_lock:
            if len(self._recent) > _MAX_TRACKED_KEYS:
                cutoff = now - AGGREGATION_WINDOW_S
                self._recent = {
                    k: v for k, v in self._recent.items() if v[0] >= cutoff
                }
                if len(self._recent) > _MAX_TRACKED_KEYS:
                    # Event storm: every key is still inside the window.
                    # Hard-cap by evicting the oldest emitters — an evicted
                    # key re-emits early (one extra Event) and its folded
                    # occurrence count is dropped with it; bounded memory
                    # beats exact counts during a storm.
                    keep = sorted(
                        self._recent.items(), key=lambda kv: -kv[1][0]
                    )[:_MAX_TRACKED_KEYS]
                    self._recent = dict(keep)
            last, suppressed, _ = self._recent.get(key, (0.0, 0, ()))
            if last and now - last < AGGREGATION_WINDOW_S:
                self._recent[key] = (last, suppressed + 1, ctx)
                return 0
            self._recent[key] = (now, 0, ctx)
            return 1 + suppressed

    def _emit(
        self, namespace: str, base: str, involved: dict,
        reason: str, message: str, type_: str,
        display: Optional[str] = None,
    ) -> None:
        # The aggregation key uses the RAW message: the displayed form
        # may carry a per-attempt trace id, and keying on that would
        # defeat the fold (every crash-loop retry would be "new").
        ctx = (namespace, base, involved, reason, display or message, type_)
        count = self._should_emit(
            (namespace, involved.get("kind"), involved.get("name"),
             reason, message),
            ctx,
        )
        if count == 0:
            return
        self._post(*ctx, count=count)

    def _post(
        self, namespace: str, base: str, involved: dict,
        reason: str, message: str, type_: str, count: int,
    ) -> None:
        now = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        body = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                # unique per emission, like client-go's name.timestamp form;
                # base truncated so the name stays under the 253-char limit
                "name": f"{base[:_MAX_BASE_LEN]}.{os.urandom(8).hex()}",
                "namespace": namespace,
            },
            "involvedObject": involved,
            "reason": reason,
            "message": message,
            "type": type_,
            "source": {"component": COMPONENT, "host": self._node},
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": count,
            "reportingComponent": COMPONENT,
            "reportingInstance": self._node,
        }
        self._sink.submit(lambda: self._client.create_event(namespace, body))


def build_event_recorder(
    kube_client, node_name: str, metrics=None, flush_window_s: float = 0.0
) -> Optional[EventRecorder]:
    if kube_client is None or not node_name:
        return None
    return EventRecorder(
        kube_client, node_name, metrics=metrics,
        flush_window_s=flush_window_s,
    )
