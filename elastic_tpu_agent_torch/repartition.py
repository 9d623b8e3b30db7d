"""Live re-partitioning: quota moves to where the work is.

The port's copy of ``elastic_tpu_agent/repartition.py``. The sampler
(sampler.py) attributes granted against used gpu-core percent per pod;
this controller acts on it for the pods that opted in:

- **Opt-in**: only pods annotated ``elasticgpu.io/repartition`` (truthy)
  take part, as donors or borrowers; every other pod keeps the grant the
  scheduler gave it.
- **Grow / shrink**: a busy opted-in pod (used >= ``busy_frac`` of its
  effective grant) takes a co-located idle pod's slack:
  ``ELASTIC_TPU_CORE_UNITS`` (and the memory quota, in the donor's
  core:memory ratio) restamped into both pods' alloc specs under the
  owner's bind stripe (:func:`plugins.restamp_owner_env`, the drain
  signal's path). Moves are bounded steps a tick, and unwind the same
  way: a donor back under pressure, a borrower gone idle, or either side
  leaving the node returns the units.
- **QoS precedence**: a high-priority pod never donates to a low one
  (``device.qos.pod_priority``: annotation, else priorityClassName, else
  low). Low may donate upward; equals may trade.
- **Escalation**: a pod whose own report stays over its effective grant
  by the margin is throttled: borrowed units revoked, the quota clamped
  to the base grant, ``ELASTIC_TPU_THROTTLE`` and its deadline stamped.
  A pod still over quota at the deadline, or one that answered the
  throttle with a checkpoint ack (migration.py), has its bindings
  reclaimed through the reconciler's ``reclaimed_pod`` repair, and the
  reconciler does not replay its still-listed assignment.

On an NVIDIA card ``ELASTIC_TPU_CORE_UNITS`` is a hint (device/qos.py):
nothing time-slices SMs by it. nvidia-smi gives no per-process duty
either, so only a pod's own measured report
(``workloads/telemetry.write_usage_report``, a file keyed by its
allocation hash) can throttle it.

Every move is journaled into the store's ``agent_state`` (key
``repartition``, the agent's JSON shape, so that either agent resumes the
other's state from one db) before any spec file changes; the fault points
``repartition.pre_journal``, ``.post_journal``, ``.mid_restamp`` and
``.pre_evict_reclaim`` (and the plugin's ``restamp.spec_file``) name the
crash windows. Every tick re-asserts the journaled quotas, and
:meth:`resume` re-applies them on restart.

Supervised DEGRADED: losing re-partitioning must not take binding down.
This module imports nothing of ``workloads/`` (torch).
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
    BytesPerMemoryUnit,
    EnvThrottle,
    EnvThrottleDeadline,
    ResourceGPUCore,
    ResourceGPUMemory,
)
from .device.qos import (
    AnnotationQoSCoreUnits,
    AnnotationQoSHBMLimit,
    EnvQoSCoreUnits,
    EnvQoSHBMFraction,
    EnvQoSHBMLimit,
    _annotation_int,
    pod_priority,
    repartition_opt_in,
)
from .storage.store import StorageError
from .types import PodContainer

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_S = 10.0
# Units moved per (donor, borrower) pair per tick — bounded steps keep
# the loop stable against noisy duty samples.
DEFAULT_STEP_UNITS = 10
# A donor is idle below this fraction of its effective grant...
DEFAULT_IDLE_FRAC = 0.5
# ...a borrower is hungry above this fraction of its effective grant...
DEFAULT_BUSY_FRAC = 0.9
# ...and a donor whose usage climbs back above this fraction reclaims.
DEFAULT_PRESSURE_FRAC = 0.75
# A donor always keeps at least this many units of its base grant.
DEFAULT_MIN_KEEP_UNITS = 10
# Overcommit margin (percentage points over the EFFECTIVE grant) and how
# many consecutive ticks sustain it before the throttle clamp.
DEFAULT_OVERCOMMIT_MARGIN = 5.0
DEFAULT_THROTTLE_AFTER_TICKS = 3
# Wall-clock grace between the throttle clamp and binding reclaim.
DEFAULT_EVICT_AFTER_S = 300.0

_STATE_KEY = "repartition"


class RepartitionController:
    """Per-node live quota renegotiator (one instance per agent)."""

    def __init__(
        self,
        sampler,
        storage,
        sitter,
        plugin,
        reconciler,
        metrics=None,
        events=None,
        timeline=None,
        node_name: str = "",
        period_s: float = DEFAULT_PERIOD_S,
        step_units: int = DEFAULT_STEP_UNITS,
        idle_frac: float = DEFAULT_IDLE_FRAC,
        busy_frac: float = DEFAULT_BUSY_FRAC,
        pressure_frac: float = DEFAULT_PRESSURE_FRAC,
        min_keep_units: int = DEFAULT_MIN_KEEP_UNITS,
        overcommit_margin: float = DEFAULT_OVERCOMMIT_MARGIN,
        throttle_after_ticks: int = DEFAULT_THROTTLE_AFTER_TICKS,
        evict_after_s: float = DEFAULT_EVICT_AFTER_S,
        clock=None,
        rng=None,
        lag_tracker=None,
        bus=None,
        event_safety_net_factor: float = 1.0,
    ) -> None:
        self._sampler = sampler
        self._storage = storage
        self._sitter = sitter
        self._plugin = plugin
        self._reconciler = reconciler
        self._metrics = metrics
        self._events = events
        self._timeline = timeline
        self._node = node_name
        self.period_s = period_s
        self.step_units = max(1, step_units)
        self.idle_frac = idle_frac
        self.busy_frac = busy_frac
        self.pressure_frac = pressure_frac
        self.min_keep_units = max(0, min_keep_units)
        self.overcommit_margin = overcommit_margin
        self.throttle_after_ticks = max(1, throttle_after_ticks)
        self.evict_after_s = evict_after_s
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._rng = rng if rng is not None else random.Random()
        self._lag = lag_tracker  # DetectionLagTracker (latency.py)
        self._lock = threading.Lock()
        # Donation ledger: every executed move is an edge (or tops up an
        # existing one), so shrink-back knows exactly whose units went
        # where. deltas are DERIVED from edges, never stored separately.
        self._edges: List[dict] = []
        # pod -> {"since_ts", "deadline_ts", "reason"}
        self._throttles: Dict[str, dict] = {}
        # pods whose bindings QoS enforcement reclaimed (pod key -> the
        # UID the eviction acted on); the reconciler must not replay
        # their still-listed kubelet assignments back. UID-pinned like
        # the throttles: a pod re-created under the same name must not
        # inherit the suppression.
        self._evicted: Dict[str, str] = {}
        # Pods owed a restamp: journaled WITH the ledger before any spec
        # file changes and cleared per pod as its restamp lands, so a
        # crash mid-commit knows exactly whose on-disk quotas may still
        # reflect the PREVIOUS ledger (an unwound edge's borrower is no
        # longer an edge endpoint — the ledger alone can't name it).
        self._pending_restamp: set = set()
        self._over_streak: Dict[str, int] = {}
        # Per-pass memo for _base_quotas: one tick (or resume) asks for
        # the same pod's store record from the meta build, the edge
        # unwind, each restamp and each throttle emit — one storage
        # load per pod per pass, not four. Cleared at every pass start.
        self._base_cache: Dict[str, Optional[dict]] = {}
        self._repartitions = {"grow": 0, "shrink": 0}
        self._throttles_total = 0
        self._evictions_total = 0
        self._last_tick_ts: Optional[float] = None
        # The sampler-view timestamp the last USAGE-DRIVEN decisions
        # were made from: a view that has not advanced (sampler slower
        # than this loop, crashed, or circuit-broken — it is DEGRADED
        # too) must not be re-judged; enforcement-grade actions need
        # fresh evidence, never one frozen measurement re-counted.
        self._last_view_ts: Optional[float] = None
        self._last_error: Optional[str] = None
        # MigrationCoordinator (migration.py), assigned by the manager:
        # gates the QoS eviction the same way acks gate drain reclaim —
        # a throttled pod that answers the clamp with a durable
        # checkpoint is evicted with its work PRESERVED (record
        # published before the teardown), and may be evicted the moment
        # the ack lands instead of at the deadline (checkpointing under
        # a throttle is the pod accepting the move).
        self.migration = None
        self._resumed = False
        # Event bus (events.py): pod deltas and store-change events wake
        # a tick early (an evicted pod vanishing, a new tenant binding).
        # The sweep stretches only while fractional sharing is DISABLED
        # (tick is a no-op then) and the bus is healthy — with sharing
        # live, enforcement deadlines and usage-driven decisions keep
        # the base cadence, since sampler pressure is not event-visible.
        self._bus = bus
        self.event_safety_net_factor = max(1.0, float(
            event_safety_net_factor
        ))
        self._event_sub = None
        if bus is not None:
            from . import events as bus_events

            self._event_sub = bus.subscribe(
                "repartition",
                (bus_events.POD_DELTA, bus_events.STORE_BIND,
                 bus_events.ASSIGNMENT_DELTA),
            )
        self.event_ticks_total = 0

    # -- derived quota state ---------------------------------------------------

    def core_delta_percent(self, pod_key: str) -> float:
        """Signed core-unit delta this controller currently applies on
        top of ``pod_key``'s base grant (1 unit == 1 core percent). The
        sampler's overcommit detector reads this so effective grants,
        not base grants, are what usage is judged against."""
        with self._lock:
            return float(self._core_delta_locked(pod_key))

    def _core_delta_locked(self, pod_key: str) -> int:
        delta = 0
        for e in self._edges:
            if e["borrower"] == pod_key:
                delta += e["core_units"]
            if e["donor"] == pod_key:
                delta -= e["core_units"]
        return delta

    def _hbm_delta_locked(self, pod_key: str) -> int:
        delta = 0
        for e in self._edges:
            if e["borrower"] == pod_key:
                delta += e.get("hbm_bytes", 0)
            if e["donor"] == pod_key:
                delta -= e.get("hbm_bytes", 0)
        return delta

    def replay_suppressed(self, pod_key: str) -> bool:
        """True while QoS enforcement reclaimed this pod's bindings and
        the pod still exists — the reconciler's unbound-assignment
        replay would otherwise faithfully re-bind them."""
        with self._lock:
            return pod_key in self._evicted

    # -- pod metadata ----------------------------------------------------------

    def _spec_plugin(self):
        return getattr(self._plugin, "core", None)

    def _fractional(self) -> bool:
        """Whole-card (exclusive) mode has no sub-card units to move."""
        plugin = self._spec_plugin()
        return plugin is not None and not getattr(
            plugin, "_whole_chip", False
        )

    def _pod_meta(self, pod_key: str):
        """(annotations, pod) from the sitter cache, or (None, None)
        when the pod is unknown there (never force an apiserver round
        trip from this loop)."""
        ns, _, name = pod_key.partition("/")
        pod = self._sitter.get_pod(ns, name)
        if pod is None:
            return None, None
        ann = (pod.get("metadata") or {}).get("annotations") or {}
        return ann, pod

    def _base_quotas(self, pod_key: str) -> Optional[dict]:
        """The pod's store-derived base grant, or None when it has no
        usable records (memoized per policy pass — see _base_cache).
        Raises StorageError when the store cannot answer: unknowable is
        NOT absence — one transient sqlite failure must never read as
        "every peer departed" and unwind the whole ledger. Quota env is
        per container; the repartition contract addresses
        single-card-container pods, so the (single) core-holding
        container is the restamp target — pods with more are skipped
        (logged once per tick via the caller)."""
        if pod_key in self._base_cache:
            return self._base_cache[pod_key]
        # only successful answers are cached: a StorageError propagates
        # (and is retried on the next call/tick) without poisoning the
        # memo
        self._base_cache[pod_key] = out = self._load_base(pod_key)
        return out

    def _peer_departed(self, pod_key: str) -> bool:
        """True only when the store POSITIVELY answers "no record" —
        an unanswerable store keeps edges and throttles in place."""
        try:
            return self._base_quotas(pod_key) is None
        except StorageError:
            return False

    def _load_base(self, pod_key: str) -> Optional[dict]:
        ns, _, name = pod_key.partition("/")
        info = self._storage.load(ns, name)
        if info is None:
            return None
        target = None
        core_containers = 0
        for container, by_resource in info.allocations.items():
            core_units = 0
            hbm_bytes = 0
            chips: set = set()
            for resource, rec in by_resource.items():
                chips.update(rec.chip_indexes)
                if resource == ResourceGPUCore:
                    core_units += len(rec.device.ids)
                elif resource == ResourceGPUMemory:
                    hbm_bytes += len(rec.device.ids) * BytesPerMemoryUnit
            if core_units:
                core_containers += 1
                target = {
                    "owner": PodContainer(ns, name, container),
                    "records": dict(by_resource),
                    "core_units": core_units,
                    "hbm_bytes": hbm_bytes,
                    "chips": chips,
                }
        if target is None or core_containers != 1:
            return None
        return target

    def _chip_hbm_bytes(self) -> int:
        """The card's memory, from the operator's cards as the plugin
        listed them (nvidia-smi's total, or the card model's)."""
        plugin = self._spec_plugin()
        chips = getattr(plugin, "_chips", None) or {}
        for chip in chips.values():
            return int(chip.hbm_bytes)
        return 0

    # -- journaled state -------------------------------------------------------

    def _journal_locked(self) -> None:
        self._storage.save_state(_STATE_KEY, {
            "edges": [dict(e) for e in self._edges],
            "throttles": {k: dict(v) for k, v in self._throttles.items()},
            "evicted": dict(self._evicted),
            "pending_restamp": sorted(self._pending_restamp),
            "repartitions_total": dict(self._repartitions),
            "throttles_total": self._throttles_total,
            "evictions_total": self._evictions_total,
        })

    def resume(self) -> None:
        """Reload the journaled ledger and re-assert every affected
        pod's quota env (idempotent — restamp skips already-correct
        files), so a crash anywhere between the journal write and the
        last spec file converges on the journaled state. Called before
        the boot reconcile (manager.run), like drain.resume, so replay
        suppression for evicted pods is armed before any repair runs."""
        self._base_cache = {}  # a re-resume must not restamp stale bases
        try:
            st = self._storage.load_state(_STATE_KEY)
        except Exception:  # noqa: BLE001 - unreadable journal: start clean
            logger.exception(
                "repartition: state journal unreadable; starting empty"
            )
            st = None
        if st:
            with self._lock:
                self._edges = [dict(e) for e in st.get("edges", [])]
                self._throttles = {
                    k: dict(v)
                    for k, v in (st.get("throttles") or {}).items()
                }
                evicted = st.get("evicted") or {}
                if isinstance(evicted, dict):
                    self._evicted = dict(evicted)
                else:  # pre-UID journal shape: a plain key list
                    self._evicted = {k: "" for k in evicted}
                self._pending_restamp = set(
                    st.get("pending_restamp", [])
                )
                self._repartitions.update(
                    st.get("repartitions_total") or {}
                )
                self._throttles_total = int(st.get("throttles_total", 0))
                self._evictions_total = int(st.get("evictions_total", 0))
                affected = (
                    self._affected_pods_locked() | self._pending_restamp
                )
            if affected:
                logger.warning(
                    "repartition: resuming journaled quota state for %s",
                    sorted(affected),
                )
            for pod_key in sorted(affected):
                try:
                    self._restamp_pod(pod_key)
                    with self._lock:
                        self._pending_restamp.discard(pod_key)
                except Exception:  # noqa: BLE001 - next tick re-asserts
                    logger.exception(
                        "repartition: resume restamp for %s failed",
                        pod_key,
                    )
            with self._lock:
                self._journal_locked()
        self._resumed = True

    def _affected_pods_locked(self) -> set:
        out = set(self._throttles)
        for e in self._edges:
            out.add(e["donor"])
            out.add(e["borrower"])
        return out

    # -- restamps --------------------------------------------------------------

    def _restamp_pod(self, pod_key: str) -> bool:
        """Re-assert ``pod_key``'s effective quota env (base grant +
        journaled deltas + throttle marker) into its on-disk alloc
        specs, under the owner's bind stripe via the shared restamp
        helper. Idempotent; returns False when the pod has no restamp
        target any more (gone, or not single-card-container)."""
        from .plugins import restamp_owner_env

        base = self._base_quotas(pod_key)
        plugin = self._spec_plugin()
        if base is None or plugin is None:
            return False
        with self._lock:
            core_delta = self._core_delta_locked(pod_key)
            hbm_delta = self._hbm_delta_locked(pod_key)
            throttle = (
                dict(self._throttles[pod_key])
                if pod_key in self._throttles else None
            )
        # The pod's own clamp-only-downward quota caps (qos.py) bind
        # restamps too: a donation unwinding (or a throttle lifting)
        # must never stamp a quota above the ceiling the pod declared
        # for itself at bind time. The ledger stays grant-denominated;
        # only the stamped env clamps.
        ann, _pod = self._pod_meta(pod_key)
        ann = ann or {}
        eff_core = max(0, base["core_units"] + core_delta)
        cap_units = _annotation_int(ann, AnnotationQoSCoreUnits)
        if cap_units is not None:
            eff_core = min(eff_core, cap_units)
        env = {EnvQoSCoreUnits: str(eff_core)}
        if base["hbm_bytes"]:
            eff_hbm = max(0, base["hbm_bytes"] + hbm_delta)
            cap_hbm = _annotation_int(ann, AnnotationQoSHBMLimit)
            if cap_hbm is not None:
                eff_hbm = min(eff_hbm, cap_hbm)
            env[EnvQoSHBMLimit] = str(eff_hbm)
            chip_hbm = self._chip_hbm_bytes()
            if chip_hbm:
                env[EnvQoSHBMFraction] = (
                    f"{min(1.0, eff_hbm / chip_hbm):.4f}"
                )
        remove = ()
        if throttle is not None:
            env[EnvThrottle] = throttle.get("reason", "overcommit")
            env[EnvThrottleDeadline] = str(int(throttle["deadline_ts"]))
        else:
            remove = (EnvThrottle, EnvThrottleDeadline)
        restamp_owner_env(
            plugin, base["owner"], base["records"], env,
            remove_keys=remove,
        )
        return True

    def _commit(self, dirty: set, moves: List[dict]) -> None:
        """Journal-then-restamp: the ledger lands durably BEFORE any
        spec file changes (a crash between the two is exactly what
        resume() converges), then every affected pod is re-stamped and
        the observability trail (metrics/timeline/events) emitted."""
        faults.fire("repartition.pre_journal")
        with self._lock:
            self._pending_restamp |= set(dirty)
            self._journal_locked()
        faults.fire("repartition.post_journal")
        for pod_key in sorted(dirty):
            try:
                self._restamp_pod(pod_key)
                with self._lock:
                    self._pending_restamp.discard(pod_key)
            except Exception:  # noqa: BLE001 - next tick re-asserts
                logger.exception(
                    "repartition: restamp for %s failed (re-asserted "
                    "next tick)", pod_key,
                )
            faults.fire("repartition.mid_restamp")
        with self._lock:
            # the pending set shrank (or kept its failures): record it
            self._journal_locked()
        for move in moves:
            self._emit_move(move)

    def _emit_move(self, move: dict) -> None:
        m = self._metrics
        direction = move["direction"]
        if self._lag is not None:
            # A move's divergence originated at whichever pod's demand
            # shift triggered it: the borrower under pressure (grow) or
            # the donor going idle (shrink). Origins come from marks
            # stamped where the shift was injected; unmarked moves
            # record nothing.
            self._lag.handled(
                "repartition", "repartition",
                key=move["borrower"] if direction == "grow"
                else move["donor"],
            )
        if m is not None and hasattr(m, "repartitions"):
            try:
                m.repartitions.labels(direction=direction).inc()
            except Exception:  # noqa: BLE001
                pass
        if self._timeline is not None:
            from .timeline import KIND_REPARTITION

            # BOTH pods' quotas changed, so both get the event in
            # their keyed history — "why did my pod's quota change?"
            # must answer from either side of the move.
            for role in ("donor", "borrower"):
                self._timeline.emit(
                    KIND_REPARTITION,
                    keys={
                        "pod": move[role],
                        "chips": [move["chip"]],
                    },
                    direction=direction,
                    role=role,
                    donor=move["donor"],
                    borrower=move["borrower"],
                    core_units=move["core_units"],
                    hbm_bytes=move.get("hbm_bytes", 0),
                    reason=move.get("reason", ""),
                )
        if self._events is not None:
            from .kube.events import ReasonRepartitioned

            ns, _, name = move["borrower"].partition("/")
            try:
                self._events.pod_event(
                    ns, name, ReasonRepartitioned,
                    f"{direction}: {move['core_units']} core unit(s) "
                    f"{'from' if direction == 'grow' else 'returned to'} "
                    f"{move['donor']} on card {move['chip']}",
                )
            except Exception:  # noqa: BLE001 - observability only
                pass
        logger.info(
            "repartition %s: %s -> %s (%d units, %d memory bytes, card %d)%s",
            direction, move["donor"], move["borrower"],
            move["core_units"], move.get("hbm_bytes", 0), move["chip"],
            f" [{move['reason']}]" if move.get("reason") else "",
        )

    # -- the policy tick -------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> dict:
        """One policy pass; returns {"grown", "shrunk", "throttled",
        "evicted"} counts for tests and the status block."""
        faults.fire("repartition.tick")
        now = self._clock.time() if now is None else now
        result = {"grown": 0, "shrunk": 0, "throttled": 0, "evicted": 0}
        self._base_cache = {}
        if not self._fractional():
            return result
        view = (
            self._sampler.utilization_view()
            if self._sampler is not None else {"pods": {}}
        )
        pods = view.get("pods", {})
        # One metadata/base pass: who is opted in, at what priority,
        # with what base grant and measured usage.
        meta: Dict[str, dict] = {}
        for key, p in pods.items():
            ann, pod = self._pod_meta(key)
            if ann is None:
                continue
            try:
                base = self._base_quotas(key)
            except StorageError:
                continue  # unknowable this pass: no policy action
            if base is None:
                continue
            with self._lock:
                eff = base["core_units"] + self._core_delta_locked(key)
            meta[key] = {
                "opted": repartition_opt_in(ann),
                "priority": pod_priority(ann, pod),
                "uid": ((pod or {}).get("metadata") or {}).get("uid", ""),
                "base": base,
                "eff": eff,
                # the pod's clamp-only-downward self-cap: growth past
                # it would strand donated units the stamped env can
                # never expose
                "cap": _annotation_int(ann, AnnotationQoSCoreUnits),
                "used": p.get("used_percent"),
                "chips": dict(p.get("chips") or {}),
                "reported": bool(p.get("self_reported")),
            }
        view_ts = view.get("ts")
        fresh = view_ts is not None and view_ts != self._last_view_ts
        dirty: set = set()
        moves: List[dict] = []
        # Structure-driven pieces (peers departing, opt-outs, evicted
        # sweeps) run every tick; USAGE-driven pieces (pressure/idle
        # shrink, escalation streaks and deadlines, growth) only act on
        # a view that advanced since the last tick.
        self._unwind_dead_edges(meta, dirty, moves, result)
        if fresh:
            self._shrink_under_pressure(meta, now, dirty, moves, result)
        # BEFORE escalation: a stale throttle inherited across a pod
        # re-creation must never contribute an instant eviction.
        self._sweep_departed_throttles(meta, dirty)
        self._escalate_overcommit(
            meta, now, dirty, moves, result, fresh
        )
        if fresh:
            self._grow_from_slack(meta, now, dirty, moves, result)
            self._last_view_ts = view_ts
        self._sweep_evicted()
        # Streaks only exist for pods in this pass's view: a departed
        # pod's partial streak must not pass to a same-name successor,
        # and the dict must not grow with pod churn.
        self._over_streak = {
            k: v for k, v in self._over_streak.items() if k in meta
        }
        with self._lock:
            # restamps a previous tick (or resume) could not complete
            # are owed until they land
            dirty |= self._pending_restamp
        if dirty or moves:
            self._commit(dirty, moves)
        with self._lock:
            self._last_tick_ts = now
        return result

    # -- policy pieces ---------------------------------------------------------

    def _drop_edge(
        self, edge: dict, units: int, reason: str,
        dirty: set, moves: List[dict], result: dict, meta=None,
    ) -> None:
        """(no lock) Return ``units`` from an edge (whole edge when
        units >= its size); accounting + ledger only, restamps ride the
        commit. When ``meta`` is given, the pass's working effective
        grants are adjusted too — a later policy piece in the SAME tick
        must judge donors/borrowers against the post-shrink reality,
        not a stale eff that lets a pod be donated below its floor."""
        units = min(units, edge["core_units"])
        if units <= 0:
            return
        frac = units / edge["core_units"]
        hbm_back = int(edge.get("hbm_bytes", 0) * frac)
        with self._lock:
            edge["core_units"] -= units
            edge["hbm_bytes"] = edge.get("hbm_bytes", 0) - hbm_back
            if edge["core_units"] <= 0:
                self._edges.remove(edge)
            self._repartitions["shrink"] += 1
        if meta is not None:
            if edge["donor"] in meta:
                meta[edge["donor"]]["eff"] += units
            if edge["borrower"] in meta:
                meta[edge["borrower"]]["eff"] -= units
        dirty.add(edge["donor"])
        dirty.add(edge["borrower"])
        result["shrunk"] += 1
        moves.append({
            "direction": "shrink",
            "donor": edge["donor"],
            "borrower": edge["borrower"],
            "chip": edge["chip"],
            "core_units": units,
            "hbm_bytes": hbm_back,
            "reason": reason,
        })

    def _unwind_dead_edges(
        self, meta: dict, dirty: set, moves: List[dict], result: dict
    ) -> None:
        """Edges whose donor or borrower left the node (record gone)
        return their units — the survivor's restamp re-derives from its
        base grant, so a vanished peer can't strand a quota."""
        with self._lock:
            edges = list(self._edges)
        for edge in edges:
            gone = [
                k for k in (edge["donor"], edge["borrower"])
                if self._peer_departed(k)
            ]
            if gone:
                self._drop_edge(
                    edge, edge["core_units"],
                    f"peer gone: {','.join(gone)}", dirty, moves,
                    result, meta=meta,
                )

    def _shrink_under_pressure(
        self, meta: dict, now: float, dirty: set, moves: List[dict],
        result: dict,
    ) -> None:
        with self._lock:
            edges = list(self._edges)
        for edge in edges:
            if edge not in self._edges:
                continue  # already unwound this tick
            donor = meta.get(edge["donor"])
            borrower = meta.get(edge["borrower"])
            if donor is not None and donor["used"] is not None and (
                donor["used"] > self.pressure_frac * max(1, donor["eff"])
            ):
                # The donor needs its units back: reclaim one step.
                self._drop_edge(
                    edge, self.step_units, "donor under pressure",
                    dirty, moves, result, meta=meta,
                )
            elif borrower is not None and borrower["used"] is not None and (
                borrower["used"]
                < self.idle_frac * max(1, borrower["eff"])
            ):
                # The borrower stopped needing the growth: decay it.
                self._drop_edge(
                    edge, self.step_units, "borrower idle",
                    dirty, moves, result, meta=meta,
                )

    def _escalate_overcommit(
        self, meta: dict, now: float, dirty: set, moves: List[dict],
        result: dict, fresh: bool = True,
    ) -> None:
        for key, m in meta.items():
            if not m["opted"]:
                # Opting out (annotations are pod-controlled, read
                # live) ends PARTICIPATION, both halves: a standing
                # throttle lifts (never stuck forever because the
                # escalation loop stopped looking), AND every edge
                # touching the pod unwinds — a non-participant must
                # not keep borrowed quota while exempt from
                # enforcement, nor keep its units lent out.
                with self._lock:
                    was_throttled = self._throttles.pop(key, None)
                    touching = [
                        e for e in self._edges
                        if key in (e["donor"], e["borrower"])
                    ]
                self._over_streak.pop(key, None)
                for edge in touching:
                    self._drop_edge(
                        edge, edge["core_units"], f"{key} opted out",
                        dirty, moves, result, meta=meta,
                    )
                if was_throttled is not None:
                    dirty.add(key)
                    self._emit_throttle(key, "unthrottle")
                    logger.info(
                        "repartition: %s opted out while throttled; "
                        "clamp lifted", key,
                    )
                continue
            if not fresh:
                # The sampler view has not advanced: one frozen
                # measurement must not accrue streaks, lift a clamp,
                # or — worst — reach an evict deadline re-counted.
                continue
            with self._lock:
                throttled = key in self._throttles
                deadline = (
                    self._throttles[key]["deadline_ts"] if throttled
                    else None
                )
                throttle_since = (
                    self._throttles[key]["since_ts"] if throttled
                    else None
                )
            if throttled:
                # A standing throttle lifts ONLY on positive evidence
                # of compliance: a fresh self-report within quota.
                # Ceasing to report is not an escape hatch — the pod
                # opted into the reporting contract, was clamped on its
                # own measured overcommit, and silence at the deadline
                # reads as non-compliance (the pod controls the file;
                # reporting honest within-quota usage is the way out).
                compliant = (
                    m["reported"] and m["used"] is not None
                    and m["used"] <= m["eff"] + self.overcommit_margin
                )
                if compliant:
                    with self._lock:
                        self._throttles.pop(key, None)
                    self._over_streak.pop(key, None)
                    dirty.add(key)
                    self._emit_throttle(key, "unthrottle")
                    logger.info(
                        "repartition: %s back within quota; throttle "
                        "lifted", key,
                    )
                    continue
                # Migration gate: a still-over-quota pod that answered
                # the throttle signal with a durable checkpoint ack has
                # accepted the move — evict NOW with the work preserved
                # instead of burning the rest of the grace deadline.
                acked_early = (
                    self.migration is not None
                    and self.migration.acked_since(key, throttle_since)
                )
                if now >= deadline or acked_early:
                    self._evict(
                        key, m.get("uid", ""), dirty, result,
                        acked=acked_early,
                    )
                continue
            if m["used"] is None:
                # Coverage lost (no telemetry, no fresh report): no
                # evidence either way — the streak resets
                # (conservative: never punishes on absence).
                self._over_streak.pop(key, None)
                continue
            # Enforcement needs MEASURED evidence: only a pod's own
            # self-report can throttle it. Remainder-attributed usage
            # is an assumption (an under-reporting co-tenant shifts
            # phantom duty onto whoever doesn't report) — it still
            # raises the sampler's overcommit ALARM, but never the
            # clamp. An under-reporter gains nothing either: its own
            # idle-looking report makes it a DONOR.
            over = m["reported"] and (
                m["used"] > m["eff"] + self.overcommit_margin
            )
            if over:
                self._over_streak[key] = self._over_streak.get(key, 0) + 1
            else:
                self._over_streak[key] = 0
            if (
                self._over_streak.get(key, 0)
                >= self.throttle_after_ticks
            ):
                # Escalate alarm -> throttle: revoke borrowed growth and
                # clamp the quota back to the base grant, deadline armed.
                with self._lock:
                    edges = [
                        e for e in self._edges if e["borrower"] == key
                    ]
                for edge in edges:
                    self._drop_edge(
                        edge, edge["core_units"], "throttled",
                        dirty, moves, result, meta=meta,
                    )
                deadline_ts = now + self.evict_after_s
                with self._lock:
                    self._throttles[key] = {
                        "since_ts": now,
                        "deadline_ts": deadline_ts,
                        "reason": "overcommit",
                        # pinned to THIS pod instance: a re-created pod
                        # under the same name starts clean
                        "uid": m.get("uid", ""),
                    }
                    self._throttles_total += 1
                dirty.add(key)
                result["throttled"] += 1
                if self._metrics is not None and hasattr(
                    self._metrics, "throttles"
                ):
                    try:
                        self._metrics.throttles.inc()
                    except Exception:  # noqa: BLE001
                        pass
                self._emit_throttle(key, "throttle", deadline_ts)
                logger.warning(
                    "repartition: %s sustained overcommit (used %.1f%% "
                    "of %d units); quota clamped, reclaim at %d",
                    key, m["used"], m["eff"], int(deadline_ts),
                )

    def _evict(
        self, key: str, uid: str, dirty: set, result: dict,
        acked: bool = False,
    ) -> None:
        """Deadline expired (or the pod acked a post-throttle
        checkpoint) with the pod still over quota: reclaim its bindings
        through the reconciler's reclaimed_pod repair class. When the
        migration coordinator holds a durable ack, a MigrationRecord is
        published FIRST so the eviction preserves the work. The evicted
        set is journaled BEFORE the teardown — a crash in between must
        leave replay suppression armed, or the boot reconcile would
        re-bind exactly what enforcement removed (the safe wrong way
        round merely re-runs the escalation)."""
        if self.migration is not None and (
            acked or self.migration.acked_since(key, None)
        ):
            # best-effort, never blocks the eviction: the record (and
            # its journal entry) outlives the reclaim either way
            self.migration.publish_record(key, uid, reason="qos_evict")
        with self._lock:
            self._throttles.pop(key, None)
            self._evicted[key] = uid
            self._evictions_total += 1
            self._journal_locked()
        faults.fire("repartition.pre_evict_reclaim")
        report = self._reconciler.reclaim_pods([key])
        self._over_streak.pop(key, None)
        dirty.discard(key)  # its specs are gone with the reclaim
        result["evicted"] += 1
        if self._metrics is not None and hasattr(
            self._metrics, "qos_evictions"
        ):
            try:
                self._metrics.qos_evictions.inc()
            except Exception:  # noqa: BLE001
                pass
        self._emit_throttle(key, "evict")
        if self._events is not None:
            from .kube.events import ReasonQoSEvicted

            ns, _, name = key.partition("/")
            try:
                self._events.pod_event(
                    ns, name, ReasonQoSEvicted,
                    "card bindings reclaimed: sustained overcommit past "
                    "the throttle deadline "
                    f"({report.get('reclaimed_pods', 0)} record(s))",
                    type_="Warning",
                )
            except Exception:  # noqa: BLE001
                pass
        logger.warning(
            "repartition: evicted %s (still over quota at the throttle "
            "deadline; %s)", key, report,
        )

    def _emit_throttle(
        self, pod_key: str, action: str,
        deadline_ts: Optional[float] = None,
    ) -> None:
        if self._timeline is not None:
            from .timeline import KIND_THROTTLE

            try:
                base = self._base_quotas(pod_key)
            except StorageError:  # the chips key is best-effort here
                base = None
            self._timeline.emit(
                KIND_THROTTLE,
                keys={
                    "pod": pod_key,
                    "chips": sorted(base["chips"]) if base else [],
                },
                action=action,
                deadline_ts=deadline_ts,
            )
        if action == "throttle" and self._events is not None:
            from .kube.events import ReasonThrottled

            ns, _, name = pod_key.partition("/")
            try:
                self._events.pod_event(
                    ns, name, ReasonThrottled,
                    "sustained overcommit: gpu-core quota clamped to the "
                    "base grant; bindings reclaimed at "
                    f"{int(deadline_ts or 0)} unless usage returns "
                    "within quota",
                    type_="Warning",
                )
            except Exception:  # noqa: BLE001
                pass

    def _grow_from_slack(
        self, meta: dict, now: float, dirty: set, moves: List[dict],
        result: dict,
    ) -> None:
        with self._lock:
            throttled = set(self._throttles)
            evicted = set(self._evicted)
        def eligible(key):
            m = meta[key]
            return (
                m["opted"] and m["used"] is not None
                and key not in throttled and key not in evicted
            )

        # A borrower must be HONESTLY hungry: at or near its quota
        # (busy_frac) but still respecting it (within the overcommit
        # margin). A pod already blowing past quota gets the
        # escalation path, never a reward.
        borrowers = [
            key for key in meta if eligible(key)
            and meta[key]["used"]
            >= self.busy_frac * max(1, meta[key]["eff"])
            and meta[key]["used"]
            <= meta[key]["eff"] + self.overcommit_margin
            # growth past the pod's own qos-core-units cap would move
            # ledger units its stamped env can never expose
            and (
                meta[key]["cap"] is None
                or meta[key]["eff"] < meta[key]["cap"]
            )
        ]
        donors = [
            key for key in meta if eligible(key)
            and meta[key]["used"]
            <= self.idle_frac * max(1, meta[key]["eff"])
            and meta[key]["eff"] - self.step_units >= self.min_keep_units
        ]
        if not borrowers or not donors:
            return
        # Most-starved borrowers first, high priority outranking low.
        borrowers.sort(key=lambda k: (
            0 if meta[k]["priority"] == "high" else 1,
            -(meta[k]["used"] / max(1, meta[k]["eff"])),
            k,
        ))
        for bkey in borrowers:
            b = meta[bkey]
            best: Optional[Tuple[str, int, int]] = None
            for dkey in donors:
                if dkey == bkey:
                    continue
                d = meta[dkey]
                # Donation precedence: high never donates to low.
                if d["priority"] == "high" and b["priority"] == "low":
                    continue
                with self._lock:
                    reverse = any(
                        e["donor"] == bkey and e["borrower"] == dkey
                        for e in self._edges
                    )
                if reverse:
                    # A standing edge the other way means the borrower
                    # is really reclaiming its own donation — that is
                    # the shrink path's job; stacking an offsetting
                    # edge would make the ledger unreadable.
                    continue
                shared = set(d["chips"]) & set(b["chips"])
                if not shared:
                    continue  # slack only moves between co-tenants
                slack = d["eff"] - self.min_keep_units
                if slack <= 0:
                    continue
                chip = min(shared)
                if best is None or slack > best[1]:
                    best = (dkey, slack, chip)
            if best is None:
                continue
            dkey, slack, chip = best
            units = min(self.step_units, slack)
            if b["cap"] is not None:
                units = min(units, b["cap"] - b["eff"])
            if units <= 0:
                continue
            d = meta[dkey]
            hbm = 0
            if d["base"]["hbm_bytes"] and b["base"]["hbm_bytes"]:
                # Ride the donor's own core:memory ratio so its residual
                # quota keeps the shape its workload was sized for.
                with self._lock:
                    donor_hbm_eff = (
                        d["base"]["hbm_bytes"]
                        + self._hbm_delta_locked(dkey)
                    )
                hbm = min(
                    donor_hbm_eff,
                    int(
                        d["base"]["hbm_bytes"]
                        * units / max(1, d["base"]["core_units"])
                    ),
                )
            with self._lock:
                for e in self._edges:
                    if (
                        e["donor"] == dkey and e["borrower"] == bkey
                        and e["chip"] == chip
                    ):
                        e["core_units"] += units
                        e["hbm_bytes"] = e.get("hbm_bytes", 0) + hbm
                        break
                else:
                    self._edges.append({
                        "donor": dkey,
                        "borrower": bkey,
                        "chip": chip,
                        "core_units": units,
                        "hbm_bytes": hbm,
                    })
                self._repartitions["grow"] += 1
            # Keep this tick's bookkeeping coherent for later donors.
            d["eff"] -= units
            b["eff"] += units
            dirty.add(dkey)
            dirty.add(bkey)
            result["grown"] += 1
            moves.append({
                "direction": "grow",
                "donor": dkey,
                "borrower": bkey,
                "chip": chip,
                "core_units": units,
                "hbm_bytes": hbm,
            })

    def _sweep_departed_throttles(self, meta: dict, dirty: set) -> None:
        """A pod deleted while throttled must take its throttle (and
        expired deadline) with it: a later pod re-created under the
        same name would otherwise inherit the stale entry and be
        evicted on its first over-quota tick with zero grace. Two
        signals: the store record is GONE (pod left, keyed sweep), or
        the live pod's UID no longer matches the one the throttle was
        armed against (same name, different pod). A sitter blip with
        the binding still present keeps the throttle armed."""
        with self._lock:
            throttled = {
                k: v.get("uid", "") for k, v in self._throttles.items()
            }
        for key, armed_uid in throttled.items():
            departed = (
                key not in meta and self._peer_departed(key)
            )
            recreated = (
                key in meta and armed_uid
                and meta[key]["uid"] != armed_uid
            )
            if not departed and not recreated:
                continue
            with self._lock:
                self._throttles.pop(key, None)
            self._over_streak.pop(key, None)
            dirty.add(key)  # journals the drop; restamp heals/no-ops
            logger.info(
                "repartition: %s %s while throttled; throttle dropped",
                key, "was re-created" if recreated else "left the node",
            )

    def _sweep_evicted(self) -> None:
        """Evicted pods drop out of the suppression set once they are
        actually gone (sitter no longer sees them) OR once the live pod
        under that name carries a different UID (deleted and re-created
        between ticks) — a re-created pod starts clean either way."""
        with self._lock:
            evicted = dict(self._evicted)
        gone = []
        for key, armed_uid in evicted.items():
            ns, _, name = key.partition("/")
            pod = self._sitter.get_pod(ns, name)
            if pod is None:
                gone.append(key)
                continue
            live_uid = (pod.get("metadata") or {}).get("uid", "")
            if armed_uid and live_uid != armed_uid:
                gone.append(key)
        if gone:
            with self._lock:
                for key in gone:
                    self._evicted.pop(key, None)
                self._journal_locked()

    # -- the supervised loop ---------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Supervised loop (DEGRADED): resume the journaled ledger, then
        tick at a jittered period (0.75x-1.25x) — the drain/reconciler
        discipline, including the 3-strikes escalation."""
        self.resume()
        consecutive_failures = 0
        last_tick = 0.0
        while True:
            delay = self.period_s * (0.75 + 0.5 * self._rng.random())
            sub = self._event_sub
            if (
                sub is not None and self._bus.healthy()
                and not self._fractional()
            ):
                # Exclusive mode: the tick has no units to move, the
                # sweep is purely a safety net — stretch it.
                delay *= self.event_safety_net_factor
            if sub is None:
                if stop.wait(delay):
                    return
            else:
                trigger = sub.wait_trigger(stop, delay)
                if trigger == "stop":
                    return
                if trigger == "event":
                    # Coalesce the burst AND pace event ticks: a churn
                    # storm degrades to ~4 extra ticks per period, not
                    # one tick per event.
                    min_gap = min(1.0, self.period_s / 4.0)
                    pace = max(0.02, min_gap - (
                        time.monotonic() - last_tick
                    ))
                    if stop.wait(pace):
                        return
                    sub.drain()
                    self.event_ticks_total += 1
            try:
                last_tick = time.monotonic()
                self.tick()
                consecutive_failures = 0
            except Exception as e:  # noqa: BLE001
                consecutive_failures += 1
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                if consecutive_failures >= 3:
                    raise
                logger.exception(
                    "repartition tick failed (%d consecutive; "
                    "escalating to the supervisor at 3)",
                    consecutive_failures,
                )

    # -- introspection ---------------------------------------------------------

    def status(self) -> dict:
        """The ``repartition`` block of /debug/allocations and the
        doctor bundle: the live donation ledger, throttle deadlines and
        lifetime totals — quota-drift triage must work from a bundle
        alone."""
        with self._lock:
            return {
                "enabled": self._fractional(),
                "period_s": self.period_s,
                "step_units": self.step_units,
                "edges": [dict(e) for e in self._edges],
                "throttled_pods": {
                    k: dict(v) for k, v in self._throttles.items()
                },
                "evicted_pods": sorted(self._evicted),
                "pending_restamp": sorted(self._pending_restamp),
                "repartitions_total": dict(self._repartitions),
                "throttles_total": self._throttles_total,
                "evictions_total": self._evictions_total,
                "last_tick_ts": self._last_tick_ts,
                "last_error": self._last_error,
            }
