"""Graceful drain lifecycle: maintenance, preemption, operator drains.

The port's copy of ``elastic_tpu_agent/drain.py``: a per-node state
machine::

    Active -> Cordoned -> Draining -> Drained | Reclaimed
       ^__________________________________________|   (trigger cleared)

driven by three trigger sources, polled each tick:

- **maintenance**: the host's maintenance event
  (``operator.maintenance_event()``; ``NvidiaOperator`` reads GCE's
  ``maintenance-event`` metadata, TTL-cached);
- **preemption**: ``operator.preempted()`` and the test-injectable notice
  ``faults.check("drain.preempt-notice")`` (arm
  ``drain.preempt-notice=notice:1``); its budget is clamped to
  ``min(deadline, preemption notice)``, and it never un-rings;
- **operator**: the ``elasticgpu.io/drain`` node annotation (a TTL-cached
  GET of the node), or :meth:`request_drain`.

On a trigger the node drains instead of failing:

1. **cordon**: both resources advertise every device Unhealthy in
   ListAndWatch (``plugin.set_cordoned``), so that the kubelet places
   nothing new, without failing health: no health Events, no Failed CRD,
   no eviction hook; resident bindings ride on;
2. **signal**: every resident's specs get ``ELASTIC_TPU_DRAIN=<trigger>``
   and ``ELASTIC_TPU_DRAIN_DEADLINE`` (``plugins.restamp_owner_env``,
   under the owner's bind stripe), with ``TPUNodeDraining`` Events on the
   node and each resident; resident slice members are annotated
   ``elasticgpu.io/draining`` so that their peers re-form first;
3. **checkpoint, then reclaim**: residents that exit take their bindings
   with them (GC); the migration coordinator (migration.py) reclaims an
   acked resident early; at the deadline whatever remains is reclaimed
   through the reconciler's repair (``reclaim_pods``);
4. **cancel**: the trigger clearing uncordons, strips the signal and the
   annotations (retried until done) and returns to Active.

Every transition is journaled (the store's ``save_state``) before its side
effects, so that an agent killed at ``drain.pre_cordon``,
``drain.post_signal`` or ``drain.pre_reclaim`` resumes the drain, cordon
and deadline included, on restart. Supervised DEGRADED: a broken drain
loop never takes binding down.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import faults
from .common import (
    SYSTEM_CLOCK,
    AnnotationDrain,
    AnnotationDraining,
    AnnotationSliceID,
    EnvDrain,
    EnvDrainDeadline,
)
from .kube.events import (
    ReasonDrainCancelled,
    ReasonMaintenanceImminent,
    ReasonNodeDrained,
    ReasonNodeDraining,
)
from .types import PodContainer

logger = logging.getLogger(__name__)

# Lifecycle states (the elastic_tpu_drain_state gauge exports the code).
ACTIVE = "active"
CORDONED = "cordoned"
DRAINING = "draining"
DRAINED = "drained"      # every resident left before the deadline
RECLAIMED = "reclaimed"  # the deadline passed; bindings reclaimed

STATE_CODES = {ACTIVE: 0, CORDONED: 1, DRAINING: 2, DRAINED: 3, RECLAIMED: 4}

# Phases of elastic_tpu_drain_phase_seconds: cordon until every resident
# carried the signal, and signal until the outcome.
PHASE_SIGNAL = "cordon_to_signaled"
PHASE_DRAINED = "signaled_to_drained"
PHASE_RECLAIMED = "signaled_to_reclaimed"

# Trigger kinds (the `trigger` label of elastic_tpu_drains_total; the full
# trigger string carries detail, e.g. "maintenance:TERMINATE_...").
TRIGGER_MAINTENANCE = "maintenance"
TRIGGER_PREEMPTION = "preemption"
TRIGGER_OPERATOR = "operator"

DEFAULT_DEADLINE_S = 300.0
# A spot host's warning before the platform takes it: a preemption drain
# clamps its budget to it, and the cutover must beat the reclaim.
DEFAULT_PREEMPTION_NOTICE_S = 30.0
DEFAULT_PERIOD_S = 2.0
# How long one GET of the node (the drain annotation) stays fresh, so that
# a fleet's ticks are not steady apiserver load.
DEFAULT_NODE_POLL_TTL_S = 10.0

_STATE_KEY = "drain"


class DrainOrchestrator:
    """Per-node graceful-drain state machine (one per agent)."""

    def __init__(
        self,
        operator,
        plugin,
        storage,
        sitter,
        reconciler,
        kube_client=None,
        events=None,
        metrics=None,
        node_name: str = "",
        deadline_s: float = DEFAULT_DEADLINE_S,
        preemption_notice_s: float = DEFAULT_PREEMPTION_NOTICE_S,
        period_s: float = DEFAULT_PERIOD_S,
        node_poll_ttl_s: float = DEFAULT_NODE_POLL_TTL_S,
        rng=None,
        timeline=None,
        clock=None,
        lag_tracker=None,
        bus=None,
        event_safety_net_factor: float = 1.0,
    ) -> None:
        self._operator = operator
        self._plugin = plugin
        self._storage = storage
        self._sitter = sitter
        self._reconciler = reconciler
        self._client = kube_client
        self._events = events
        self._metrics = metrics
        self._node = node_name
        self.deadline_s = deadline_s
        self.preemption_notice_s = max(0.0, float(preemption_notice_s))
        self.period_s = period_s
        self.node_poll_ttl_s = node_poll_ttl_s
        self._node_ann_asserted = False
        self._node_ann_next_poll = 0.0
        self._rng = rng if rng is not None else random.Random()
        self._timeline = timeline
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        # With an event bus, record deletes, state writes and pod deltas
        # wake a tick mid-drain (the last resident leaving converges on
        # the event); the idle tick keeps its period (maintenance comes
        # from a poll no event carries), and stretched waits never pass
        # the reclaim deadline (run()).
        self._bus = bus
        self.event_safety_net_factor = max(1.0, float(
            event_safety_net_factor))
        self._event_sub = None
        if bus is not None:
            from . import events as bus_events

            self._event_sub = bus.subscribe(
                "drain",
                (bus_events.POD_DELTA, bus_events.STORE_BIND,
                 bus_events.STORE_STATE),
            )
        self.event_ticks_total = 0
        # wall-clock phase anchors ("cordon", "signaled") and the phases
        # observed, journaled: a restart keeps measuring from the real
        # start and observes no phase twice
        self._phase_ts: Dict[str, float] = {}
        self._phases_observed: List[str] = []
        self._lock = threading.Lock()
        self.state = ACTIVE
        self.trigger = ""
        self.deadline_ts: Optional[float] = None
        self._drain_requested = False
        self._drain_reason = "admin"
        self._maint_active = False  # the first-sighting edge
        self._last_maint_value: Optional[str] = None  # for status()
        self._drains_total = 0
        # The outcome of the last completed drain: drained_acked (every
        # signalled resident acked a durable checkpoint, through the
        # migration coordinator the manager wires in), drained_exited (an
        # exit proves nothing), drained_empty, reclaimed or cancelled.
        self.outcome = ""
        self._acked_pods: List[str] = []
        self.migration = None  # MigrationCoordinator (manager-wired)
        self._reclaimed_pods: List[str] = []
        self._stamped_pods: List[str] = []
        self._annotated_pods: List[Tuple[str, str]] = []  # (ns, name)
        self._last_error: Optional[str] = None
        self._resumed = False
        # DetectionLagTracker (latency.py): origin (the operator's stamp)
        # -> detected (the first sighting) -> repaired (residents
        # signalled)
        self._lag = lag_tracker

    def _origin_ts(self, kind: str) -> Optional[float]:
        """The injection origin when the operator records one (the stub
        does; real metadata carries none)."""
        fn = getattr(self._operator, "origin_ts", None)
        if fn is None:
            return None
        try:
            return fn(kind)
        except Exception:  # noqa: BLE001 - accounting never breaks a poll
            return None

    # -- admin seam -----------------------------------------------------------

    def request_drain(self, reason: str = "admin") -> None:
        """A local operator-requested drain (the node annotation is
        polled from the apiserver)."""
        with self._lock:
            self._drain_requested = True
            self._drain_reason = reason

    def cancel_request(self) -> None:
        with self._lock:
            self._drain_requested = False

    # -- trigger polling ------------------------------------------------------

    def _maintenance_value(self) -> Optional[str]:
        fn = getattr(self._operator, "maintenance_event", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 - a broken poll must not wedge
            logger.exception("maintenance poll failed")
            return None

    def _note_maintenance(self, value: Optional[str]) -> bool:
        """The first sighting of an announced event posts
        TPUMaintenanceImminent and raises the gauge, drain or no drain;
        clearing drops the gauge. None (the endpoint unreachable) is
        unknowable: the gauge and the edge keep their last state."""
        if value is None:
            return False
        announced = value not in ("", "NONE")
        if announced and not self._maint_active:
            logger.warning("host maintenance imminent: %s", value)
            if self._lag is not None:
                self._lag.detected(
                    "drain", TRIGGER_MAINTENANCE, key=self._node,
                    origin_ts=self._origin_ts("maintenance"),
                )
            self._node_event(
                ReasonMaintenanceImminent,
                f"host maintenance announced: {value}; cordoning and "
                "draining this node's GPU workloads", type_="Warning")
        if self._metrics is not None:
            self._metrics.maintenance_imminent.set(1 if announced else 0)
        self._maint_active = announced
        return announced

    def _node_event(self, reason: str, message: str,
                    type_: str = "Normal") -> None:
        if self._events is None:
            return
        try:
            self._events.node_event(reason, message, type_=type_)
        except Exception:  # noqa: BLE001 - observability only
            logger.exception("drain event emit failed")

    def _poll_trigger(self) -> Optional[str]:
        """The trigger asserted now (None = all quiet): read to start a
        drain and to see mid-drain that its cause went away."""
        maint = self._maintenance_value()
        self._last_maint_value = maint
        maint_announced = self._note_maintenance(maint)
        # Preemption outranks maintenance: with both asserted the drain
        # carries the trigger that never cancels. Consuming the injected
        # notice latches preemption, as a real notice never un-rings.
        if faults.check("drain.preempt-notice"):
            setter = getattr(self._operator, "set_preempted", None)
            if setter is not None:
                setter(True)
            return f"{TRIGGER_PREEMPTION}:notice"
        preempted = getattr(self._operator, "preempted", None)
        if preempted is not None:
            try:
                if preempted():
                    if self._lag is not None:
                        self._lag.detected(
                            "drain", TRIGGER_PREEMPTION, key=self._node,
                            origin_ts=self._origin_ts("preempted"),
                        )
                    return TRIGGER_PREEMPTION
            except Exception:  # noqa: BLE001
                logger.exception("preemption poll failed")
        if maint_announced:
            return f"{TRIGGER_MAINTENANCE}:{maint}"
        if maint is None and self.trigger.startswith(TRIGGER_MAINTENANCE):
            # unreachable is not cleared: a metadata blip must not cancel
            # a maintenance drain
            return self.trigger
        with self._lock:
            if self._drain_requested:
                return f"{TRIGGER_OPERATOR}:{self._drain_reason}"
        if self._client is not None and self._node:
            now = self._clock.monotonic()
            if now >= self._node_ann_next_poll or self.node_poll_ttl_s <= 0:
                self._node_ann_next_poll = now + self.node_poll_ttl_s
                try:
                    node = self._client.get_node(self._node)
                except Exception:  # noqa: BLE001 - apiserver blip
                    # unanswerable must not cancel an annotation drain
                    if self.trigger.startswith(
                        TRIGGER_OPERATOR + ":annotation"
                    ):
                        return self.trigger
                else:
                    ann = (
                        ((node or {}).get("metadata") or {})
                        .get("annotations") or {}
                    )
                    self._node_ann_asserted = str(
                        ann.get(AnnotationDrain, "")
                    ).lower() in ("true", "1", "yes", "drain")
            if self._node_ann_asserted:
                return f"{TRIGGER_OPERATOR}:annotation"
        return None

    @staticmethod
    def _cancelable(trigger: str) -> bool:
        """Maintenance and operator drains cancel when their cause clears;
        a preemption notice never un-rings."""
        return not trigger.startswith(TRIGGER_PREEMPTION)

    # -- residents ------------------------------------------------------------

    def _residents(self) -> Optional[List[Tuple[PodContainer, Dict]]]:
        """(owner, records by resource) for every container this node
        holds bindings for; None when the store cannot answer (never read
        as no residents: that would complete the drain and skip the
        reclaim)."""
        out: List[Tuple[PodContainer, Dict]] = []
        try:
            items = list(self._storage.items())
        except Exception:  # noqa: BLE001 - storage blip: retry next tick
            logger.exception("drain: resident enumeration failed")
            return None
        for _key, info in items:
            for container, by_resource in info.allocations.items():
                if by_resource:
                    out.append((
                        PodContainer(info.namespace, info.name, container),
                        dict(by_resource),
                    ))
        return out

    # -- journaled transitions ------------------------------------------------

    def _journal(self) -> None:
        """Persist the current state (before the transition's side
        effects, so that a crash replays into it)."""
        self._storage.save_state(_STATE_KEY, {
            "state": self.state,
            "trigger": self.trigger,
            "deadline_ts": self.deadline_ts,
            "stamped_pods": list(self._stamped_pods),
            "annotated_pods": [list(p) for p in self._annotated_pods],
            "reclaimed_pods": list(self._reclaimed_pods),
            "drains_total": self._drains_total,
            "outcome": self.outcome,
            "acked_pods": list(self._acked_pods),
            "phase_ts": dict(self._phase_ts),
            "phases_observed": list(self._phases_observed),
        })

    def _set_state(self, state: str, **timeline_attrs) -> None:
        prev = self.state
        self.state = state
        if self._metrics is not None:
            self._metrics.drain_state.set(STATE_CODES[state])
        if prev != state and self._timeline is not None:
            from .timeline import KIND_DRAIN_TRANSITION

            self._timeline.emit(
                KIND_DRAIN_TRANSITION,
                **{"state": state, "from": prev,
                   "trigger": self.trigger,
                   "deadline_ts": self.deadline_ts,
                   **timeline_attrs},
            )

    def _observe_phase(self, phase: str, since_anchor: str) -> None:
        """Observe one phase's duration once a drain (the anchors and the
        observed set ride the journal); from the cordon when the signal
        anchor never landed, so that a drain whose residents could not be
        signalled is not the one the histogram omits."""
        anchor = self._phase_ts.get(since_anchor)
        if anchor is None:
            anchor = self._phase_ts.get("cordon")
        if anchor is None or phase in self._phases_observed:
            return
        self._phases_observed.append(phase)
        if self._metrics is not None:
            self._metrics.drain_phase_seconds.labels(phase=phase).observe(
                max(0.0, self._clock.time() - anchor))

    def resume(self) -> None:
        """Re-enter the journaled lifecycle after a restart (or a respawn
        of this loop): the cordon for any state but Active, then tick()
        goes on; the deadline is wall-clock, so an agent down past it
        reclaims on its first tick. Idempotent."""
        try:
            st = self._storage.load_state(_STATE_KEY)
        except Exception:  # noqa: BLE001 - unreadable journal: start clean
            logger.exception("drain: state journal unreadable; starting "
                             "Active")
            st = None
        if not st:
            self._resumed = True
            return
        with self._lock:
            # trigger and deadline first, so that the resumed transition's
            # row carries them
            self.trigger = st.get("trigger", "")
            self.deadline_ts = st.get("deadline_ts")
            self._stamped_pods = list(st.get("stamped_pods", []))
            self._annotated_pods = [
                tuple(p) for p in st.get("annotated_pods", [])
            ]
            self._reclaimed_pods = list(st.get("reclaimed_pods", []))
            self._drains_total = int(st.get("drains_total", 0))
            self.outcome = st.get("outcome", "")
            self._acked_pods = list(st.get("acked_pods", []))
            self._phase_ts = dict(st.get("phase_ts", {}))
            self._phases_observed = list(st.get("phases_observed", []))
            self._set_state(st.get("state", ACTIVE), resumed=True)
            resumed_state = self.state
        if resumed_state != ACTIVE:
            logger.warning(
                "drain: resuming journaled state %r (trigger %r, "
                "deadline %s)", resumed_state, self.trigger,
                self.deadline_ts,
            )
            self._plugin.set_cordoned(True)
            if resumed_state in (CORDONED, DRAINING):
                self._signal_residents()  # idempotent
        else:
            self._plugin.set_cordoned(False)
        self._resumed = True

    # -- the lifecycle --------------------------------------------------------

    def _drain_budget_s(self, trigger: str) -> float:
        """The configured deadline, clamped to the preemption notice when
        the host itself is going away."""
        if (
            trigger.split(":", 1)[0] == TRIGGER_PREEMPTION
            and self.preemption_notice_s > 0.0
        ):
            return min(self.deadline_s, self.preemption_notice_s)
        return self.deadline_s

    def _start_drain(self, trigger: str) -> None:
        now = self._clock.time()
        budget_s = self._drain_budget_s(trigger)
        with self._lock:
            self.trigger = trigger
            self.deadline_ts = now + budget_s
            self._drains_total += 1
            self._stamped_pods = []
            self._annotated_pods = []
            self._reclaimed_pods = []
            self.outcome = ""
            self._acked_pods = []
            self._phase_ts = {"cordon": now}
            self._phases_observed = []
            self._set_state(CORDONED)
            self._journal()  # before any side effect
        faults.fire("drain.pre_cordon")
        self._plugin.set_cordoned(True)
        logger.warning(
            "drain: node cordoned (trigger %s, deadline in %.0fs%s)",
            trigger, budget_s,
            (" - clamped to the preemption notice"
             if budget_s < self.deadline_s else ""),
        )
        self._node_event(
            ReasonNodeDraining,
            f"draining GPU workloads ({trigger}): cards unschedulable, "
            "residents signalled to checkpoint; bindings reclaimed in "
            f"{budget_s:.0f}s", type_="Warning")
        with self._lock:
            self._set_state(DRAINING)
            self._journal()
        self._signal_residents()
        if self._lag is not None:
            # repaired = residents signalled
            cls = trigger.split(":", 1)[0]
            origin = self._origin_ts(
                "preempted" if cls == TRIGGER_PREEMPTION else "maintenance"
            ) if cls in (TRIGGER_PREEMPTION, TRIGGER_MAINTENANCE) else None
            self._lag.repaired(
                "drain", cls, key=self._node, origin_ts=origin
            )
        faults.fire("drain.post_signal")

    def _signal_residents(self, residents=None) -> None:
        """Stamp the deadline-bearing signal into every resident's specs
        and mark resident slice members draining at the apiserver.
        Idempotent and cheap (an already-stamped spec is not rewritten):
        resume() and every Draining tick repeat it, catching pods bound
        mid-cordon and specs a drift rebind rebuilt."""
        from .plugins import restamp_owner_env

        plugin = self._plugin.core  # the plugins share the spec dir
        if residents is None:
            residents = self._residents()
        if residents is None:
            return  # the store cannot answer: next tick
        env = {
            EnvDrain: self.trigger,
            EnvDrainDeadline: str(int(self.deadline_ts or 0)),
        }
        stamped = set(self._stamped_pods)
        annotated = set(self._annotated_pods)
        for owner, records in residents:
            try:
                n = restamp_owner_env(plugin, owner, records, env)
            except Exception:  # noqa: BLE001 - next tick retries
                logger.exception(
                    "drain: signal restamp for %s failed", owner.pod_key
                )
                continue
            if n and owner.pod_key not in stamped:
                stamped.add(owner.pod_key)
                if self._events is not None:
                    try:
                        self._events.pod_event(
                            owner.namespace, owner.name, ReasonNodeDraining,
                            f"node draining ({self.trigger}): checkpoint "
                            "now; GPU bindings are reclaimed at "
                            f"{EnvDrainDeadline}={env[EnvDrainDeadline]}",
                            type_="Warning",
                        )
                    except Exception:  # noqa: BLE001
                        pass
            # the peers must see a slice member as lost before the host
            # goes, so that the survivors re-form ahead of the loss
            key = (owner.namespace, owner.name)
            if key in annotated or self._client is None:
                continue
            pod = self._sitter.get_pod(owner.namespace, owner.name)
            ann = ((pod or {}).get("metadata") or {}).get("annotations") or {}
            if not ann.get(AnnotationSliceID):
                continue
            try:
                self._client.patch_pod_annotations(
                    owner.namespace, owner.name,
                    {AnnotationDraining: "true"},
                )
                annotated.add(key)
            except Exception:  # noqa: BLE001 - next tick retries
                logger.warning(
                    "drain: draining-annotation patch for %s failed "
                    "(retried next tick)", owner.pod_key,
                )
        with self._lock:
            self._stamped_pods = sorted(stamped)
            self._annotated_pods = sorted(annotated)
            if "signaled" not in self._phase_ts and stamped >= {
                owner.pod_key for owner, _ in residents
            }:
                # every current resident carries the signal (an empty
                # node vacuously); later residents do not move the anchor
                self._phase_ts["signaled"] = self._clock.time()
                self._observe_phase(PHASE_SIGNAL, "cordon")
            self._journal()

    def started_ts(self) -> Optional[float]:
        """The current drain's wall-clock anchor (the cordon; journaled).
        The migration coordinator counts only acks at or after it."""
        with self._lock:
            return self._phase_ts.get("cordon")

    def _classify_outcome(self) -> Tuple[str, List[str]]:
        """(outcome, acked pods) of a drain completing as Drained:
        drained_acked only when every signalled resident acked a durable
        checkpoint after the cordon (an exit alone may be a crash)."""
        acked: List[str] = []
        if self.migration is not None:
            started = self._phase_ts.get("cordon")
            acked = [
                k for k in self._stamped_pods
                if self.migration.acked_since(k, started)
            ]
        if not self._stamped_pods:
            return "drained_empty", acked
        if set(acked) >= set(self._stamped_pods):
            return "drained_acked", acked
        return "drained_exited", acked

    def _count_outcome(self, outcome: str, trigger: str = "") -> None:
        if self._metrics is not None:
            self._metrics.drains_total.labels(
                trigger=(trigger or self.trigger).split(":", 1)[0],
                outcome=outcome,
            ).inc()

    def _cancel_drain(self) -> None:
        """The trigger cleared: re-admit the node. The journal goes first
        (a crash mid-cancel converges to Active and uncordoned); the
        stamped and annotated lists stay in it as the cleanup owed,
        retried from Active ticks and across restarts until done."""
        logger.warning("drain: trigger %r cleared; re-admitting node",
                       self.trigger)
        cancelled_trigger = self.trigger
        stamped = list(self._stamped_pods)
        with self._lock:
            was_completed = self.state in (DRAINED, RECLAIMED)
            self._set_state(ACTIVE)
            self.trigger = ""
            self.deadline_ts = None
            if not was_completed:
                # a completed drain keeps its outcome
                self.outcome = "cancelled"
            self._journal()
        if not was_completed:
            self._count_outcome("cancelled", trigger=cancelled_trigger)
        self._plugin.set_cordoned(False)
        self._finish_cancel_cleanup()
        self._node_event(
            ReasonDrainCancelled,
            f"drain cancelled ({cancelled_trigger} cleared): cards "
            f"re-schedulable, drain signal removed from {len(stamped)} "
            "resident pod(s)")

    def _finish_cancel_cleanup(self) -> None:
        """Strip the signal from every resident's specs and clear the
        draining annotations, dropping each item from the journaled lists
        only once it succeeded (a 404 on the patch: the pod is gone)."""
        from .plugins import restamp_owner_env

        if self._stamped_pods:
            residents = self._residents()
            if residents is not None:
                cleaned = True
                for owner, records in residents:
                    try:
                        restamp_owner_env(
                            self._plugin.core, owner, records, {},
                            remove_keys=(EnvDrain, EnvDrainDeadline),
                        )
                    except Exception:  # noqa: BLE001 - retried next tick
                        cleaned = False
                        logger.exception(
                            "drain: signal removal for %s failed "
                            "(retried)", owner.pod_key,
                        )
                if cleaned:
                    with self._lock:
                        self._stamped_pods = []
                        self._journal()
        # without a client the annotation debt stays journaled, owed for
        # when one exists
        if self._annotated_pods and self._client is not None:
            remaining = []
            for ns, name in self._annotated_pods:
                try:
                    self._client.patch_pod_annotations(
                        ns, name, {AnnotationDraining: None}
                    )
                except Exception:  # noqa: BLE001 - retried next tick
                    logger.warning(
                        "drain: draining-annotation clear for %s/%s "
                        "failed (retried)", ns, name,
                    )
                    remaining.append((ns, name))
            with self._lock:
                self._annotated_pods = sorted(remaining)
                self._journal()

    def _reclaim(self) -> None:
        """The deadline passed: reclaim every remaining binding through the
        reconciler's repair (counted as reclaimed_pod), leaving no orphan.
        The pods may still exist (eviction is the node controller's job),
        so the reconciler replays no assignment while reclaimed
        (suppress_replays)."""
        faults.fire("drain.pre_reclaim")
        residents = self._residents()
        if residents is None:
            return  # the store cannot answer: next tick
        keys = sorted({owner.pod_key for owner, _ in residents})
        report = {}
        if keys:
            logger.warning(
                "drain: deadline expired with %d resident pod(s); "
                "reclaiming bindings: %s", len(keys), keys,
            )
            report = self._reconciler.reclaim_pods(keys)
            if self._metrics is not None:
                self._metrics.drain_reclaimed_pods.inc(
                    report.get("reclaimed_pods", 0))
        # only pods whose records are gone count as reclaimed; the others
        # stay residents and the next past-deadline tick retries them
        after = self._residents()
        remaining = (
            {owner.pod_key for owner, _ in after}
            if after is not None else set(keys)
        )
        done = [k for k in keys if k not in remaining]
        with self._lock:
            # a union: a straggler reclaimed later keeps the first wave
            self._reclaimed_pods = sorted(
                set(self._reclaimed_pods) | set(done)
            )
            if remaining:
                self._journal()
            else:
                _, acked = self._classify_outcome()
                self.outcome = "reclaimed"
                self._acked_pods = sorted(acked)
                prev = self.state
                self._set_state(RECLAIMED, reclaimed_pods=sorted(done))
                self._observe_phase(PHASE_RECLAIMED, "signaled")
                self._journal()
                if prev != RECLAIMED:
                    self._count_outcome("reclaimed")
        if remaining:
            logger.warning(
                "drain: %d resident(s) survived the reclaim (%s); "
                "retried next tick", len(remaining), sorted(remaining),
            )
            return
        self._node_event(
            ReasonNodeDrained,
            "drain deadline expired: reclaimed GPU bindings of "
            f"{len(keys)} resident pod(s) "
            f"({report.get('reclaimed_pods', 0)} records, "
            f"{report.get('sweep_failures', 0)} sweep failures)",
            type_="Warning")

    def _finish_drained(self) -> None:
        with self._lock:
            outcome, acked = self._classify_outcome()
            self.outcome = outcome
            self._acked_pods = sorted(acked)
            prev = self.state
            self._set_state(
                DRAINED, outcome=outcome, acked_pods=sorted(acked)
            )
            self._observe_phase(PHASE_DRAINED, "signaled")
            self._journal()
        if prev != DRAINED:
            self._count_outcome(outcome)
        logger.info(
            "drain: all residents gone before the deadline (%s: %d/%d "
            "acknowledged a durable checkpoint)", outcome, len(acked),
            len(self._stamped_pods),
        )
        if outcome == "drained_acked":
            detail = ("every resident's checkpoint was verified durable "
                      "before its bindings went")
        elif outcome == "drained_empty":
            detail = "no resident workloads were bound"
        else:
            detail = (
                f"residents exited but only {len(acked)}/"
                f"{len(self._stamped_pods)} acknowledged a checkpoint: "
                "unverified exits may have lost work"
            )
        self._node_event(
            ReasonNodeDrained,
            f"drain complete ({self.trigger}, {outcome}): {detail}; node "
            "remains cordoned until the trigger clears")

    # -- reconciler integration -----------------------------------------------

    def suppress_replays(self) -> bool:
        """True while reclaimed bindings must stay reclaimed: the kubelet
        still lists the assignments of pods not yet evicted, which the
        reconciler would otherwise re-bind."""
        with self._lock:
            if self.state == RECLAIMED:
                return True
            return (
                self.state == DRAINING
                and self.deadline_ts is not None
                and self._clock.time() >= self.deadline_ts
            )

    # -- the tick -------------------------------------------------------------

    def tick(self) -> str:
        """One state-machine step; returns the (possibly new) state."""
        faults.fire("drain.tick")
        trigger = self._poll_trigger()
        state = self.state
        if (
            state != ACTIVE
            and trigger is not None
            and not self._cancelable(trigger)
            and self._cancelable(self.trigger)
        ):
            # A preemption arriving mid-drain makes it non-cancelable,
            # and clamps the deadline to the notice (never extends it).
            logger.warning(
                "drain: trigger upgraded %r -> %r (non-cancelable)",
                self.trigger, trigger,
            )
            upgraded_from = self.trigger
            clamp_ts = self._clock.time() + self._drain_budget_s(trigger)
            with self._lock:
                self.trigger = trigger
                if self.deadline_ts is None or clamp_ts < self.deadline_ts:
                    self.deadline_ts = clamp_ts
                self._journal()
            if self._timeline is not None:
                from .timeline import KIND_DRAIN_TRANSITION

                self._timeline.emit(
                    KIND_DRAIN_TRANSITION, state=self.state,
                    trigger=trigger, upgraded_from=upgraded_from,
                    deadline_ts=self.deadline_ts,
                )
        if state == ACTIVE:
            if trigger is not None:
                self._start_drain(trigger)
            elif self._stamped_pods or self._annotated_pods:
                # the cleanup a cancelled drain owes
                self._finish_cancel_cleanup()
        elif state in (CORDONED, DRAINING):
            if trigger is None and self._cancelable(self.trigger):
                self._cancel_drain()
            else:
                if state == CORDONED:
                    # a crash between the Cordoned and Draining journal
                    # writes: finish the entry
                    with self._lock:
                        self._set_state(DRAINING)
                        self._journal()
                # one store snapshot a tick; None (unknowable) never
                # completes the drain
                residents = self._residents()
                self._signal_residents(residents)
                if residents is None:
                    pass
                elif not residents:
                    self._finish_drained()
                elif (
                    self.deadline_ts is not None
                    and self._clock.time() >= self.deadline_ts
                ):
                    self._reclaim()
        elif state in (DRAINED, RECLAIMED):
            if trigger is None and self._cancelable(self.trigger):
                self._cancel_drain()
            else:
                # a bind that raced the final empty snapshot: re-signal it
                # and let it fall under the deadline reclaim
                residents = self._residents()
                if residents:
                    logger.warning(
                        "drain: %d resident(s) appeared after the drain "
                        "completed; re-entering draining", len(residents),
                    )
                    with self._lock:
                        self._set_state(DRAINING)
                        self._journal()
                    self._signal_residents(residents)
        return self.state

    def run(self, stop: threading.Event) -> None:
        """Supervised loop (DEGRADED): resume the journaled lifecycle,
        then tick at a jittered period (0.75x-1.25x)."""
        self.resume()
        consecutive_failures = 0
        while True:
            delay = self.period_s * (0.75 + 0.5 * self._rng.random())
            sub = self._event_sub
            with self._lock:
                state, deadline_ts = self.state, self.deadline_ts
            if (
                sub is not None and state != ACTIVE
                and self._bus.healthy()
            ):
                # mid-lifecycle resident changes arrive as store events,
                # so the sweep may stretch, never past the deadline
                delay *= self.event_safety_net_factor
                if deadline_ts is not None:
                    to_deadline = deadline_ts - self._clock.time()
                    delay = max(0.05, min(delay, to_deadline + 0.05))
            if sub is None:
                if stop.wait(delay):
                    return
            else:
                end = time.monotonic() + delay
                while True:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break  # the periodic tick
                    trigger = sub.wait_trigger(stop, remaining)
                    if trigger == "stop":
                        return
                    if trigger == "poll":
                        break
                    if state == ACTIVE:
                        # idle: churn is irrelevant here; keep waiting out
                        # the same period
                        sub.drain()
                        if stop.wait(0.05):
                            return
                        continue
                    if stop.wait(0.01):  # coalesce the burst
                        return
                    sub.drain()
                    self.event_ticks_total += 1
                    break
            try:
                self.tick()
                consecutive_failures = 0
            except Exception as e:  # noqa: BLE001
                # one-off failures are absorbed; persistent ones go to the
                # supervisor
                consecutive_failures += 1
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                if consecutive_failures >= 3:
                    raise
                logger.exception(
                    "drain tick failed (%d consecutive; escalating to "
                    "the supervisor at 3)", consecutive_failures,
                )

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        """The ``drain`` block of /debug/allocations and the doctor bundle.
        The maintenance value is the loop's last poll, never a fetch from
        a handler thread."""
        maint = self._last_maint_value
        with self._lock:
            deadline_in = (
                round(self.deadline_ts - self._clock.time(), 3)
                if self.deadline_ts is not None else None
            )
            return {
                "state": self.state,
                "trigger": self.trigger,
                "deadline_ts": self.deadline_ts,
                "deadline_in_s": deadline_in,
                "deadline_s": self.deadline_s,
                "preemption_notice_s": self.preemption_notice_s,
                "drains_total": self._drains_total,
                "outcome": self.outcome,
                "acked_pods": list(self._acked_pods),
                "stamped_pods": list(self._stamped_pods),
                "annotated_pods": [
                    f"{ns}/{name}" for ns, name in self._annotated_pods
                ],
                "reclaimed_pods": list(self._reclaimed_pods),
                "maintenance_event": maint,
                "last_error": self._last_error,
            }
