"""Continuous reconciler: the restore path, promoted to a subsystem.

The port's copy of ``elastic_tpu_agent/reconciler.py``. Every bind is a
journaled transaction (``Storage.journal_intent`` written before the first
side effect, committed inside the bind stripe after the checkpoint:
``plugins/gpushare.py``). An intent that survives is a bind a crash cut
short: the reconciler rolls it FORWARD when its record was checkpointed
(re-creating the recorded links) and BACK otherwise (deleting the planned
links, unlinking the spec, restoring the sibling specs); when the
kubelet's pod-resources view proves the assignment still stands, it
replays the whole bind.

Each pass diffs four sources of truth (the checkpoint store, the
kubelet's pod-resources snapshot with device ids, the links under the dev
root and the alloc specs, and the live pods) and repairs each class of
divergence, counted in its report: links a reboot wiped (re-created to
``/dev/nvidia<minor>``), missing specs (rebuilt by a rebind), records of
dead pods (reclaimed), orphan links and specs (swept), a kubelet's
device-id drift (rebound), unbound assignments (replayed). Repairs that
act on an observed absence are confirmed across two passes before acting;
the boot pass (``boot=True``, run before the device-plugin servers exist)
acts at once. ``dry_run`` makes periodic passes observers; the boot pass
still repairs.

The agent's observability hooks are ported, each optional: every repair
is counted in ``elastic_tpu_reconcile_repairs_total{kind}``, journaled as
one ``reconcile_repair`` timeline event and reported to the
detection-lag tracker; a repairing periodic pass posts one
``TPUReconciled`` node Event; the boot pass reconciles the node's
ElasticTPU objects against the store. With an event bus, pod deltas,
assignment deltas and store-change notifications start a targeted pass
at once, and the periodic sweep stretches by ``event_safety_net_factor``
while the bus is healthy (never while the last pass left work
outstanding).

The drain, the repartition controller and the migration coordinator are
assigned after all exist (``drain``, ``repartition``, ``migration``):
while the drain has reclaimed this node's bindings past its deadline, the
record walk rebuilds nothing and no kubelet assignment is replayed; a pod
that QoS enforcement evicted, and an acked resident reclaimed early, are
not replayed until the pod is gone. ``reclaim_pods`` is their teardown,
the dead-pod repair run under each owner's bind stripe.

Slice membership is a divergence class too (``slice_reformer``, a
``slices.SliceReformer``): every pass diffs the hosts stamped into each
slice member's specs against the members live at the shared apiserver and
re-forms a member whose slice lost or regained a host. The boot pass first
re-learns every stamped world and epoch, so that no rebind of the pass
stamps a stale annotation world over a reformed spec. A reform needs two
sightings, the second from a fresh LIST (a membership snapshot can outlive
a pass); a membership the apiserver cannot answer is never counted as a
loss: it is reported (``slice_check_errors``) and the node is not
converged.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

from . import events as bus_events
from . import faults
from .common import AllocSidecarSubdirs
from .storage.store import StorageError
from .tracing import get_tracer
from .types import Device, PodContainer

logger = logging.getLogger(__name__)

# Event-triggered pass pacing: a burst of bus events (one bind emits
# several store notifications) coalesces behind one short debounce, and
# event-triggered passes never start closer together than the minimum
# interval.
EVENT_DEBOUNCE_S = 0.01
EVENT_MIN_INTERVAL_S = 0.05

DEFAULT_PERIOD_S = 30.0

# Divergence classes (the agent's; docs/operations.md documents each
# symptom -> repair pairing).
KIND_RESTORED_LINK = "restored_link"        # recorded link missing on disk
KIND_RESTORED_SPEC = "restored_spec"        # recorded spec file missing
KIND_RECLAIMED_POD = "reclaimed_pod"        # record for a pod that is gone
KIND_ORPHAN_LINK = "orphan_link"            # link with no record/intent
KIND_ORPHAN_SPEC = "orphan_spec"            # spec with no record/intent
KIND_INTENT_COMMITTED = "intent_committed"  # journal row outlived its commit
KIND_INTENT_ROLLED_BACK = "intent_rolled_back"  # crashed mid-bind: undo
KIND_REPLAYED_BIND = "replayed_bind"        # kubelet assignment, no record
KIND_REBOUND_DRIFT = "rebound_drift"        # kubelet reassigned device ids
KIND_SLICE_REFORMED = "slice_reformed"      # slice membership changed: re-form

# The single source of truth for divergence classes: metric label ->
# report counter key. _count(), _new_report() and run()'s repaired sum
# all derive from it, so adding a class is one edit.
KIND_REPORT_KEY = {
    KIND_RESTORED_LINK: "restored_links",
    KIND_RESTORED_SPEC: "restored_specs",
    KIND_RECLAIMED_POD: "reclaimed_pods",
    KIND_ORPHAN_LINK: "orphan_links",
    KIND_ORPHAN_SPEC: "orphan_specs",
    KIND_INTENT_COMMITTED: "intents_committed",
    KIND_INTENT_ROLLED_BACK: "intents_rolled_back",
    KIND_REPLAYED_BIND: "replayed_binds",
    KIND_REBOUND_DRIFT: "rebound_drift",
    KIND_SLICE_REFORMED: "slice_reforms",
}
ALL_KINDS = tuple(KIND_REPORT_KEY)


def _new_report(boot: bool, dry_run: bool) -> dict:
    # restored_links/reclaimed_pods/kept_pods/corrupt_records/
    # orphan_links/orphan_specs are the historical restore() report
    # contract (tests and the Restored node event read them).
    report = {key: 0 for key in KIND_REPORT_KEY.values()}
    report.update({
        "kept_pods": 0,
        "corrupt_records": 0,
        "sweep_failures": 0,
        "replay_failures": 0,
        "slice_check_errors": 0,  # membership unknowable this pass
        "slice_reform_failures": 0,
        "divergences_observed": 0,  # dry-run: repairs that WOULD run
        "snapshot_error": None,
        "boot": boot,
        "dry_run": dry_run,
    })
    return report


class Reconciler:
    """Supervised convergence loop over store <-> kubelet <-> disk <-> pods.

    Registered with the supervisor as DEGRADED: a broken reconciler must
    not take binding down with it; the node keeps serving Allocate and
    PreStart while ``status()`` shows the loss of self-repair.
    """

    def __init__(
        self,
        storage,
        operator,
        plugin,
        sitter,
        snapshot_source=None,
        alloc_spec_dir: str = "",
        metrics=None,
        events=None,
        crd_recorder=None,
        period_s: float = DEFAULT_PERIOD_S,
        dry_run: bool = False,
        rng=None,
        slice_reformer=None,
        timeline=None,
        lag_tracker=None,
        bus=None,
        event_safety_net_factor: float = 1.0,
    ) -> None:
        self._storage = storage
        self._operator = operator
        self._plugin = plugin
        self._sitter = sitter
        self._source = snapshot_source
        self._alloc_dir = alloc_spec_dir
        self._metrics = metrics
        self._events = events
        self._crd = crd_recorder
        self._timeline = timeline
        self._lag = lag_tracker
        # the SliceReformer (slices/recovery.py): member loss or return
        # re-forms the member's slice
        self._slices = slice_reformer
        # DrainOrchestrator, RepartitionController and
        # MigrationCoordinator, assigned by the manager once all exist
        # (module docstring)
        self.drain = None
        self.repartition = None
        self.migration = None
        self.period_s = period_s
        self.dry_run = dry_run
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._repairs: Dict[str, int] = {k: 0 for k in ALL_KINDS}
        self._sweep_failures_total = 0
        self._replay_failures_total = 0
        self._slice_reform_failures_total = 0
        self._runs_total = 0
        self._last_run_ts: Optional[float] = None
        self._last_duration_s: Optional[float] = None
        self._last_converged_ts: Optional[float] = None
        self._last_report: dict = {}
        # Two-pass confirmation state: candidates seen on the previous
        # completed pass; acted on when seen again.
        self._prev_candidates: set = set()
        self._tick_candidates: set = set()
        # Replay failure backoff: key -> (consecutive failures,
        # runs_total before which no retry happens). A never-bindable
        # assignment (e.g. a pod using our resources without the
        # elastic scheduler: its bind fails by design) must not be
        # re-attempted and warn-logged every pass forever.
        self._replay_backoff: Dict[tuple, tuple] = {}
        self._last_error: Optional[str] = None
        # Event-driven passes (events.py): the periodic sweep stays the
        # correctness backstop for dropped events, stretched while the
        # bus is healthy.
        self._bus = bus
        self.event_safety_net_factor = max(1.0, float(
            event_safety_net_factor))
        self._event_sub = None
        if bus is not None:
            self._event_sub = bus.subscribe(
                "reconciler",
                (bus_events.POD_DELTA, bus_events.ASSIGNMENT_DELTA,
                 bus_events.STORE_BIND, bus_events.STORE_INTENT),
            )
        self._event_passes_total = 0
        # what woke the running pass ("event" | "poll"), for the lag
        # tracker
        self._pass_trigger = "poll"
        # pod keys whose records the triggering events saw DELETED: commit-
        # ordered proof of a persistent divergence, exempt from the
        # two-pass confirmation for this one pass
        self._event_evidence: set = set()

    # -- plumbing -------------------------------------------------------------

    def _count(
        self, report: dict, kind: str, keys: Optional[dict] = None,
        emit: bool = True, **attrs,
    ) -> None:
        report[KIND_REPORT_KEY[kind]] += 1
        with self._lock:
            self._repairs[kind] = self._repairs.get(kind, 0) + 1
        m = self._metrics
        if m is not None and hasattr(m, "reconcile_repairs"):
            try:
                m.reconcile_repairs.labels(kind=kind).inc()
            except Exception:  # noqa: BLE001 - metrics never break repair
                pass
        if self._lag is not None:
            # The reconciler both detects and repairs in one pass, so
            # one call observes both stages; key resolution mirrors the
            # timeline keys (pod first, then the device hash).
            self._lag.handled(
                "reconciler", kind,
                key=(keys or {}).get("pod") or (keys or {}).get("hash")
                or "",
                trigger=self._pass_trigger,
            )
        if emit and self._timeline is not None:
            from .timeline import KIND_RECONCILE_REPAIR

            # One journal event per repair, divergence class as an
            # attribute: per-entity histories show WHAT the reconciler
            # did to them, not just that repairs happened somewhere.
            self._timeline.emit(
                KIND_RECONCILE_REPAIR, keys=keys,
                **{"class": kind, **attrs},
            )

    def _sweep_failure(self, report: dict) -> None:
        report["sweep_failures"] += 1
        with self._lock:
            self._sweep_failures_total += 1
        m = self._metrics
        if m is not None:
            try:
                m.orphan_sweep_failures.inc()
            except Exception:  # noqa: BLE001 - metrics never break repair
                pass

    def _replay_failure(self, report: dict) -> None:
        report["replay_failures"] += 1
        with self._lock:
            self._replay_failures_total += 1

    def _candidate(self, key: tuple) -> None:
        self._tick_candidates.add(key)

    def _confirmed(self, key: tuple) -> bool:
        """True when this divergence was already observed on the
        previous pass (so it is persistent, not an in-flight bind)."""
        self._candidate(key)  # keep confirming for the next pass too
        return key in self._prev_candidates

    def _plugin_for(self, resource: str):
        """The plugin of ``resource``; None for another resource."""
        return self._plugin.plugin_for_resource(resource)

    def _pod_alive(self, namespace: str, name: str):
        """(pod_or_None, known) — ``known`` False when the apiserver
        could not be asked (never treat 'cannot tell' as 'gone')."""
        pod = self._sitter.get_pod(namespace, name)
        if pod is not None:
            return pod, True
        try:
            return self._sitter.get_pod_from_api(namespace, name), True
        except Exception as e:  # noqa: BLE001 - apiserver down: keep state
            logger.warning(
                "reconcile: apiserver check failed for %s/%s: %s",
                namespace, name, e,
            )
            return None, False

    # -- one pass -------------------------------------------------------------

    def reconcile_once(self, boot: bool = False,
                       trigger: str = "poll") -> dict:
        """One full convergence pass; returns the per-class report.

        ``boot=True`` is the agent-startup restore: it runs before the
        device-plugin servers register (no bind can be in flight), so
        every repair acts at once and the CRD objects are reconciled too.
        Periodic passes confirm absence-based repairs across two passes
        and honor ``dry_run``. ``trigger`` records what woke the pass
        ("event" or "poll") for the detection-lag tracker.
        """
        faults.fire("reconciler.tick")
        self._pass_trigger = str(trigger)
        t_pass = time.monotonic()
        active = boot or not self.dry_run
        report = _new_report(boot, self.dry_run and not boot)
        self._tick_candidates = set()

        # Artifact snapshot FIRST: any link/spec a healthy in-flight
        # bind has made by now is named by its journal intent (written
        # before creation) or its committed record — both read AFTER
        # this point — so the orphan sweep can never eat a live bind.
        links: List[str] = []
        if hasattr(self._operator, "list_links"):
            links = list(self._operator.list_links())
        try:
            # .json.tmp: _write_json_atomic's temp, leaked by a crash
            # between write and rename — named by hash, so the journal
            # invariant covers it exactly like the final file.
            spec_files = [
                f for f in os.listdir(self._alloc_dir)
                if f.endswith(".json") or f.endswith(".json.tmp")
            ]
        except OSError:
            spec_files = []

        # ONE journal read per pass, taken after the artifact snapshot
        # and BEFORE any pods-table read: intent rows are removed only
        # AFTER their record is checkpointed, so journal-before-store
        # guarantees every pre-snapshot artifact of a healthy bind is in
        # this list or in the (later-read) records — never in neither.
        # Over-inclusion (an intent resolved later this pass) only makes
        # the sweep's known set larger, which is safe.
        # Journal/store read failures RAISE (run() escalates persistent
        # ones to the supervisor): silently returning an empty report
        # would look exactly like a healthy quiet pass while the node
        # has lost all self-repair.
        intents = self._storage.open_intents()
        corrupt = self._storage.corrupt_keys()
        report["corrupt_records"] = len(corrupt)

        assignments = None
        if self._source is not None:
            try:
                with get_tracer().span("reconcile_snapshot"):
                    assignments = self._source.assignments()
            except Exception as e:  # noqa: BLE001 - kubelet down: partial pass
                report["snapshot_error"] = str(e)
                logger.warning(
                    "reconcile: pod-resources snapshot unavailable "
                    "(%s); skipping kubelet-diff repairs", e,
                )

        if boot and self._slices is not None:
            # BEFORE any repair that can rebind (intent replay, drift
            # rebind): a cold registry's pod_env would stamp the stale
            # annotation world at epoch 0 over a reformed spec
            with get_tracer().span("reconcile_slice_prelearn"):
                self._prelearn_slices()
        with get_tracer().span("reconcile_intents"):
            self._resolve_intents(intents, report, boot, active)
        with get_tracer().span("reconcile_records"):
            self._walk_records(report, assignments, boot, active)
        with get_tracer().span("reconcile_orphans"):
            self._sweep_orphans(
                links, spec_files, intents, corrupt, report, boot, active
            )
        with get_tracer().span("reconcile_unbound"):
            self._replay_unbound(assignments, report, boot, active)
        if self._slices is not None:
            with get_tracer().span("reconcile_slices"):
                self._reconcile_slices(report, boot, active)
        if boot and self._crd is not None:
            self._reconcile_crd()

        report["pending_confirmation"] = len(self._tick_candidates)
        report["repaired_total"] = sum(
            report[key] for key in KIND_REPORT_KEY.values()
        )
        if not boot and report["repaired_total"] and self._events is not None:
            # one batched node Event a repairing periodic pass (the boot
            # pass's is posted by NodeManager.restore())
            from .kube.events import ReasonReconciled

            try:
                self._events.node_event(
                    ReasonReconciled,
                    "reconciler repaired "
                    + ", ".join(
                        f"{report[key]} {kind}"
                        for kind, key in KIND_REPORT_KEY.items()
                        if report[key]
                    ),
                )
            except Exception:  # noqa: BLE001 - observability only
                logger.exception("reconcile event emit failed")
        duration_s = time.monotonic() - t_pass
        report["duration_s"] = duration_s
        # Converged = the pass ended with NOTHING outstanding: no failed
        # sweep/replay, kubelet answerable, no corrupt rows, nothing
        # observed diverged (dry-run) or awaiting confirmation. Repairs
        # that SUCCEEDED don't block convergence.
        converged = (
            report["sweep_failures"] == 0
            and report["replay_failures"] == 0
            and report["snapshot_error"] is None
            and report["corrupt_records"] == 0
            and report["divergences_observed"] == 0
            and report["pending_confirmation"] == 0
            # a membership the apiserver cannot answer may hide a lost
            # member: the apiserver's counterpart of snapshot_error
            and report["slice_check_errors"] == 0
            and report["slice_reform_failures"] == 0
        )
        wall_now = time.time()
        with self._lock:
            self._prev_candidates = self._tick_candidates
            self._tick_candidates = set()
            self._runs_total += 1
            self._last_run_ts = wall_now
            self._last_duration_s = duration_s
            if converged:
                self._last_converged_ts = wall_now
            self._last_report = dict(report)
        m = self._metrics
        if m is not None:
            try:
                m.reconcile_runs.inc()
                m.reconcile_duration.observe(duration_s)
                if converged:
                    m.reconcile_last_converged.set(wall_now)
                m.open_bind_intents.set(len(self._storage.open_intents()))
            except Exception:  # noqa: BLE001
                pass
        return report

    # -- intents --------------------------------------------------------------

    def _resolve_intents(
        self, intents: List[dict], report: dict, boot: bool, active: bool
    ) -> None:
        for intent in intents:
            if self._storage.intent_inflight(intent["id"]):
                # A live bind thread in this process owns the row — no
                # matter how slowly it is going (sqlite busy retries, a
                # stalled hostPath, stripe queueing in a rebind burst),
                # it is not debris. The marker is exact: the bind's
                # finally drops it on every exit, so a thread that died
                # stops shielding its row immediately.
                continue
            key = ("intent", intent["id"])
            if not active:
                self._candidate(key)
                report["divergences_observed"] += 1
                continue
            if not boot and not self._confirmed(key):
                # First sighting: belt and braces on top of the
                # in-flight marker. Confirm on the next pass.
                continue
            self._resolve_intent(intent, report)

    def _resolve_intent(self, intent: dict, report: dict) -> None:
        from .plugins import gpushare

        namespace, _, name = intent["pod_key"].partition("/")
        owner = PodContainer(namespace, name, intent["container"])
        resource = intent["resource"]
        alloc_hash = intent["hash"]
        payload = intent.get("payload", {})
        plugin = self._plugin_for(resource)
        with gpushare.bind_lock(owner.pod_key):
            # Re-check under the owner's bind stripe: commits happen
            # inside this stripe, so an intent still open here cannot
            # belong to a bind that is past its checkpoint.
            if not self._storage.intent_open(intent["id"]):
                return
            try:
                info = self._storage.load(namespace, name)
            except StorageError:
                # Corrupt checkpoint row: we cannot prove this bind
                # un-happened — leave the intent for the operator
                # (corrupt_records is alarmed separately).
                logger.warning(
                    "reconcile: intent %d for %s left open — checkpoint "
                    "record is corrupt", intent["id"], owner.pod_key,
                )
                return
            rec = None
            if info is not None:
                rec = info.allocations.get(
                    intent["container"], {}
                ).get(resource)
            if rec is not None and rec.device.hash == alloc_hash:
                # The bind reached its commit point (record checkpointed)
                # and died before dropping the journal row. Roll FORWARD:
                # make sure the recorded artifacts exist, then commit.
                for pos, link_id in enumerate(rec.created_node_ids):
                    if not self._operator.check(link_id):
                        try:
                            self._operator.create(
                                rec.chip_indexes[pos], link_id
                            )
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "reconcile: re-create %s failed", link_id
                            )
                self._storage.journal_remove(intent["id"])
                self._count(
                    report, KIND_INTENT_COMMITTED,
                    keys={"pod": owner.pod_key,
                          "container": owner.container,
                          "hash": alloc_hash},
                    intent_id=intent["id"], resource=resource,
                )
                logger.info(
                    "reconcile: intent %d (%s %s) was committed; journal "
                    "row dropped", intent["id"], owner.pod_key, alloc_hash,
                )
                return
            # A concurrent RETRY bind for the same device set journals
            # its own intent before creating links — and those links
            # carry the same hash-derived names this intent planned.
            # If such a sibling intent exists, the artifacts may be the
            # retry's, not this corpse's: drop only the stale row and
            # let the live bind (or its own recovery) own the rest.
            try:
                retry_exists = any(
                    i["id"] != intent["id"] and i["hash"] == alloc_hash
                    for i in self._storage.open_intents()
                )
            except StorageError:
                retry_exists = True  # can't tell: stay non-destructive
            if retry_exists:
                self._storage.journal_remove(intent["id"])
                self._count(
                    report, KIND_INTENT_ROLLED_BACK,
                    keys={"pod": owner.pod_key,
                          "container": owner.container,
                          "hash": alloc_hash},
                    intent_id=intent["id"], resource=resource,
                    reason="superseded_by_retry",
                )
                logger.info(
                    "reconcile: dropped stale intent %d for %s — a "
                    "newer intent owns hash %s", intent["id"],
                    owner.pod_key, alloc_hash,
                )
                return
            # The bind never committed: undo every side effect it may
            # have gotten to (all idempotent — ENOENT deletes succeed).
            for link_id in payload.get("planned_link_ids", []):
                try:
                    self._operator.delete(link_id)
                except Exception:  # noqa: BLE001
                    logger.warning(
                        "reconcile: rollback delete %s failed", link_id
                    )
                    self._sweep_failure(report)
            if plugin is not None:
                plugin.remove_alloc_spec_locked(alloc_hash, owner)
            else:
                try:
                    os.unlink(
                        os.path.join(self._alloc_dir, f"{alloc_hash}.json")
                    )
                except OSError:
                    pass
            self._storage.journal_remove(intent["id"])
            self._count(
                report, KIND_INTENT_ROLLED_BACK,
                keys={"pod": owner.pod_key,
                      "container": owner.container,
                      "hash": alloc_hash,
                      "chips": list(payload.get("chip_indexes", []))},
                intent_id=intent["id"], resource=resource,
                reason="crashed_mid_bind",
            )
            logger.warning(
                "reconcile: rolled back crashed bind intent %d "
                "(%s %s %s)", intent["id"], owner.pod_key, resource,
                alloc_hash,
            )

    # -- store walk -----------------------------------------------------------

    def _walk_records(
        self, report: dict, assignments, boot: bool, active: bool
    ) -> None:
        # Reverse index of kubelet's view: who is assigned what, by owner.
        owner_assign: Dict[tuple, tuple] = {}
        if assignments is not None:
            for resource, by_hash in assignments.items():
                for h, (owner, ids) in by_hash.items():
                    owner_assign[
                        (owner.pod_key, owner.container, resource)
                    ] = (h, ids)
        for key, info in list(self._storage.items()):
            pod, known = self._pod_alive(info.namespace, info.name)
            if pod is None and not known:
                report["kept_pods"] += 1
                continue
            if pod is None:
                if active:
                    self._reclaim_pod(info, report)
                else:
                    report["divergences_observed"] += 1
                continue
            report["kept_pods"] += 1
            for container, by_resource in list(info.allocations.items()):
                for resource, record in list(by_resource.items()):
                    if self.drain is not None and (
                        self.drain.suppress_replays()
                    ):
                        # the drain's reclaim is tearing bindings down
                        # under this walk's snapshot: a rebuild here would
                        # resurrect them (checked per record, so that a
                        # reclaim starting mid-pass stops it at once)
                        continue
                    owner = PodContainer(
                        info.namespace, info.name, container
                    )
                    cur = owner_assign.get((key, container, resource))
                    if cur is not None and cur[0] != record.device.hash:
                        # kubelet reassigned this container's device ids
                        # (kubelet restart wipes its device manager state)
                        # — kubelet's view is what the container's cgroup
                        # rules were built from, so it wins.
                        dkey = ("drift", key, container, resource)
                        if not active:
                            self._candidate(dkey)
                            report["divergences_observed"] += 1
                        elif boot or self._confirmed(dkey):
                            self._repair_drift(owner, record, cur, report)
                        continue
                    self._repair_artifacts(
                        owner, record, resource, report, active
                    )

    def _repair_artifacts(
        self, owner, record, resource: str, report: dict, active: bool
    ) -> None:
        """Recorded allocation, live pod: its links and spec must exist."""
        for pos, link_id in enumerate(record.created_node_ids):
            if self._operator.check(link_id):
                continue
            if not active:
                report["divergences_observed"] += 1
                continue
            try:
                self._operator.create(record.chip_indexes[pos], link_id)
                self._count(
                    report, KIND_RESTORED_LINK,
                    keys={"pod": owner.pod_key,
                          "container": owner.container,
                          "hash": record.device.hash,
                          "chips": [record.chip_indexes[pos]]},
                    link=link_id,
                )
            except Exception:  # noqa: BLE001
                logger.exception("reconcile: re-create %s failed", link_id)
        plugin = self._plugin_for(resource)
        if plugin is None or plugin.alloc_spec_exists(record.device.hash):
            return
        if not active:
            report["divergences_observed"] += 1
            return
        # The spec file feeds the OCI hook / NRI adjustment at the
        # container's NEXT start; rebuild it by replaying the bind
        # (idempotent — same device, same record, re-merged siblings).
        try:
            plugin.rebind(owner, record.device)
            self._count(
                report, KIND_RESTORED_SPEC,
                keys={"pod": owner.pod_key, "container": owner.container,
                      "hash": record.device.hash,
                      "chips": list(record.chip_indexes)},
                resource=resource,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "reconcile: spec rebuild for %s %s failed: %s",
                owner.pod_key, record.device.hash, e,
            )
            self._replay_failure(report)

    def _repair_drift(self, owner, record, cur: tuple, report: dict) -> None:
        from .plugins import gpushare

        new_hash, new_ids = cur
        resource = record.device.resource
        plugin = self._plugin_for(resource)
        if plugin is None:
            return
        with gpushare.bind_lock(owner.pod_key):
            # Somebody (a live bind, a previous repair) may have already
            # converged this record — re-check under the stripe.
            try:
                info = self._storage.load(owner.namespace, owner.name)
            except StorageError:
                return
            rec = None
            if info is not None:
                rec = info.allocations.get(owner.container, {}).get(resource)
            if rec is None or rec.device.hash != record.device.hash:
                return
            for link_id in rec.created_node_ids:
                try:
                    self._operator.delete(link_id)
                except Exception:  # noqa: BLE001
                    logger.warning(
                        "reconcile: drift cleanup delete %s failed", link_id
                    )
                    self._sweep_failure(report)
            plugin.remove_alloc_spec_locked(rec.device.hash, owner)
            # Drop the stale record NOW: if the rebind below fails, the
            # store must not keep claiming links we just deleted (the
            # assignment stays visibly unbound and is replayed later).
            self._storage.mutate(
                owner.namespace, owner.name,
                lambda i: i.allocations.get(
                    owner.container, {}
                ).pop(resource, None),
            )
            if self._crd is not None:
                try:
                    self._crd.record_released(rec.device.hash)
                except Exception:  # noqa: BLE001 - observability only
                    pass
        try:
            plugin.rebind(owner, Device(list(new_ids), resource))
            self._count(
                report, KIND_REBOUND_DRIFT,
                keys={"pod": owner.pod_key, "container": owner.container,
                      "hash": new_hash},
                resource=resource, old_hash=record.device.hash,
            )
            logger.warning(
                "reconcile: %s %s re-bound after kubelet device-id drift "
                "(%s -> %s)", owner.pod_key, resource,
                record.device.hash, new_hash,
            )
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "reconcile: drift rebind for %s %s failed: %s",
                owner.pod_key, resource, e,
            )
            self._replay_failure(report)

    def _reclaim_pod(self, info, report: dict, locked: bool = False) -> None:
        """Tear down a pod's bindings: links, specs, the record. For a
        dead pod the spec removal alone takes the stripe (no bind of it
        can be in flight); ``locked=True``: the caller holds the owner's
        stripe (``reclaim_pods``, live pods), and the stripes are not
        reentrant."""
        spec_plugin = self._plugin.core  # the plugins share the spec dir
        for container, by_resource in info.allocations.items():
            owner = PodContainer(info.namespace, info.name, container)
            for record in by_resource.values():
                for link_id in record.created_node_ids:
                    try:
                        self._operator.delete(link_id)
                    except Exception:  # noqa: BLE001
                        logger.warning(
                            "reconcile: reclaim delete %s failed "
                            "(retried next pass)", link_id,
                        )
                        self._sweep_failure(report)
                if locked:
                    spec_plugin.remove_alloc_spec_locked(
                        record.device.hash, owner)
                else:
                    spec_plugin.remove_alloc_spec(record.device.hash, owner)
                if self._crd is not None:
                    try:
                        self._crd.record_released(record.device.hash)
                    except Exception:  # noqa: BLE001
                        pass
        self._storage.delete(info.namespace, info.name)
        self._count(
            report, KIND_RECLAIMED_POD,
            keys={"pod": info.key},
            hashes=[record.device.hash for record in info.records()],
        )
        logger.info("reconcile: reclaimed pod %s", info.key)

    def reclaim_pods(self, pod_keys) -> dict:
        """Policy reclaim of the named pods' bindings (the drain's deadline
        and the migration coordinator's early reclaim), through the
        dead-pod repair: counted as ``reclaimed_pod``, no orphan left. The
        pods may still be live, so each teardown holds the owner's bind
        stripe against its binds and this reconciler's repairs, and each
        caller suppresses replays until its pods are gone."""
        from .plugins import gpushare

        report = _new_report(boot=False, dry_run=False)
        for pod_key in pod_keys:
            namespace, _, name = pod_key.partition("/")
            try:
                info = self._storage.load(namespace, name)
            except StorageError:
                logger.warning(
                    "policy reclaim: %s has a corrupt record; left for "
                    "the corrupt-row runbook", pod_key,
                )
                continue
            if info is None:
                continue
            try:
                with gpushare.bind_lock(pod_key):
                    self._reclaim_pod(info, report, locked=True)
            except Exception:  # noqa: BLE001 - reclaim the rest
                logger.exception("policy reclaim: %s failed", pod_key)
                self._sweep_failure(report)
        return report

    # -- orphan sweep ---------------------------------------------------------

    def _sweep_orphans(
        self,
        links: List[str],
        spec_files: List[str],
        intents: List[dict],
        corrupt: List[str],
        report: dict,
        boot: bool,
        active: bool,
    ) -> None:
        if corrupt:
            # A corrupt checkpoint row may describe a LIVE allocation
            # whose links/specs we can no longer enumerate; sweeping now
            # could destroy state under a running container. Stay
            # non-destructive until the row is gone.
            logger.warning(
                "reconcile: skipping orphan sweep — %d corrupt checkpoint "
                "record(s) present", len(corrupt),
            )
            return
        # Known set: the pass-start journal read (taken BEFORE the store
        # read — intent rows only disappear after their record lands, so
        # nothing healthy can fall between the two) plus a records read
        # taken after it. `intents` being pre-resolution only ever makes
        # this set larger, which is safe.
        known_links: set = set()
        known_hashes: set = set()
        for intent in intents:
            known_links.update(intent["payload"].get("planned_link_ids", []))
            known_hashes.add(intent["hash"])
        for _, info in self._storage.items():
            for record in info.records():
                known_links.update(record.created_node_ids)
                known_hashes.add(record.device.hash)
        for link_id in links:
            if link_id in known_links:
                continue
            if not self._operator.check(link_id):
                # Already gone (an intent rollback this pass, a bind's
                # own rollback): a vanished entry from the snapshot is
                # not a divergence — don't count phantom repairs, and
                # don't alarm a dry-run operator with them.
                continue
            if link_id.endswith(".tmp") and not boot:
                # A pending atomic-create temp is never named by any
                # intent (temp names embed pid+thread), so the journal
                # invariant doesn't cover it — a live create could be
                # microseconds from its rename. Crash debris is still
                # there next pass; a pending temp is not.
                if not self._confirmed(("orphan_tmp", link_id)):
                    continue
            if not active:
                report["divergences_observed"] += 1
                continue
            try:
                self._operator.delete(link_id)
                self._count(report, KIND_ORPHAN_LINK, link=link_id)
            except Exception:  # noqa: BLE001
                # NOT dropped forever any more: counted, and retried on
                # the next pass (the link stays unrecorded).
                logger.warning(
                    "reconcile: orphan delete %s failed (retried next "
                    "pass)", link_id,
                )
                self._sweep_failure(report)
        for fname in spec_files:
            stem = (
                fname[: -len(".json.tmp")] if fname.endswith(".json.tmp")
                else fname[: -len(".json")]
            )
            if stem in known_hashes:
                continue
            if not os.path.exists(os.path.join(self._alloc_dir, fname)):
                continue  # vanished since the snapshot: not a divergence
            if not active:
                report["divergences_observed"] += 1
                continue
            try:
                os.unlink(os.path.join(self._alloc_dir, fname))
                self._count(report, KIND_ORPHAN_SPEC, keys={"hash": stem})
                # the allocation's sidecar files die with its spec (the
                # list remove_alloc_spec uses)
                for subdir in AllocSidecarSubdirs:
                    for suffix in (".json", ".json.tmp"):
                        try:
                            os.unlink(os.path.join(
                                self._alloc_dir, subdir,
                                stem + suffix,
                            ))
                        except OSError:
                            pass
            except FileNotFoundError:
                pass
            except OSError:
                logger.warning(
                    "reconcile: orphan spec unlink %s failed (retried "
                    "next pass)", fname,
                )
                self._sweep_failure(report)

    # -- unbound kubelet assignments ------------------------------------------

    def _replay_unbound(
        self, assignments, report: dict, boot: bool, active: bool
    ) -> None:
        """kubelet says a live container holds our devices, the store has
        no record: a bind that crashed before its checkpoint (or whose
        intent was rolled back above). Replay it end to end."""
        if assignments is None:
            return
        if self.drain is not None and self.drain.suppress_replays():
            # the drain reclaimed this node's bindings past its deadline;
            # the pods' assignments may outlive the reclaim until eviction
            logger.info(
                "reconcile: unbound-assignment replay suppressed "
                "(node drain reclaimed bindings)"
            )
            return
        for resource in sorted(assignments):
            plugin = self._plugin_for(resource)
            if plugin is None:
                continue  # not our extended resource
            for alloc_hash in sorted(assignments[resource]):
                owner, ids = assignments[resource][alloc_hash]
                if self.repartition is not None and (
                    self.repartition.replay_suppressed(owner.pod_key)
                ):
                    # evicted by the throttle escalation: replaying would
                    # re-bind what it tore down
                    continue
                if self.migration is not None and (
                    self.migration.replay_suppressed(owner.pod_key)
                ):
                    # reclaimed early on its acked checkpoint: the
                    # assignment stays reclaimed until the pod goes
                    continue
                try:
                    info = self._storage.load(owner.namespace, owner.name)
                except StorageError:
                    continue  # corrupt: never double-bind over it
                rec = None
                if info is not None:
                    rec = info.allocations.get(
                        owner.container, {}
                    ).get(resource)
                if rec is not None:
                    continue  # bound (drift is the record walk's job)
                # Keyed by OWNER too: under churn a reclaimed pod's
                # device set can return under a NEW pod (same chip/unit
                # pattern, fresh assignment) within one pass window —
                # without the owner in the key, the dead generation's
                # candidate would insta-confirm the new one and replay
                # a bind that is seconds from binding itself.
                ukey = ("unbound", resource, alloc_hash, owner.pod_key)
                if not active:
                    self._candidate(ukey)
                    report["divergences_observed"] += 1
                    continue
                if not boot and not self._confirmed(ukey) and (
                    owner.pod_key not in self._event_evidence
                ):
                    # kubelet assigns devices BEFORE PreStartContainer
                    # runs; a fresh assignment is normally seconds from
                    # binding itself. Only replay ones that stay unbound
                    # across two passes, UNLESS the triggering events
                    # held this pod's store-delete notification: the
                    # store itself confirmed the record is gone (an
                    # in-flight bind never emits a delete).
                    continue
                failures, next_run = self._replay_backoff.get(ukey, (0, 0))
                if not boot and self._runs_total < next_run:
                    continue  # backing off a repeatedly-failing replay
                pod, known = self._pod_alive(owner.namespace, owner.name)
                if pod is None:
                    continue  # stale kubelet state or unknowable: skip
                try:
                    plugin.rebind(owner, Device(list(ids), resource))
                    self._count(
                        report, KIND_REPLAYED_BIND,
                        keys={"pod": owner.pod_key,
                              "container": owner.container,
                              "hash": alloc_hash},
                        resource=resource,
                    )
                    self._replay_backoff.pop(ukey, None)
                    logger.warning(
                        "reconcile: replayed unbound assignment %s %s -> "
                        "%s", resource, alloc_hash, owner.pod_key,
                    )
                except Exception as e:  # noqa: BLE001
                    # Exponential pass-count backoff (2,4,...,32): an
                    # assignment that CANNOT bind — e.g. a pod that
                    # bypassed the elastic scheduler, so the bind fails
                    # its annotation check by design — must not be
                    # retried and warn-logged every pass for the pod's
                    # whole lifetime.
                    failures += 1
                    self._replay_backoff[ukey] = (
                        failures,
                        self._runs_total + min(2 ** failures, 32),
                    )
                    logger.warning(
                        "reconcile: replay of %s %s for %s failed "
                        "(attempt %d, next retry in ~%d passes): %s",
                        resource, alloc_hash, owner.pod_key, failures,
                        min(2 ** failures, 32), e,
                    )
                    self._replay_failure(report)
        # Assignments that disappeared take their backoff state with
        # them (pod deleted, or finally bound via a real PreStart).
        live_keys = {
            ("unbound", res, h, by_hash[h][0].pod_key)
            for res, by_hash in assignments.items()
            for h in by_hash
        }
        for key in [k for k in self._replay_backoff if k not in live_keys]:
            del self._replay_backoff[key]

    # -- slice membership (slices/recovery.py) --------------------------------

    def _prelearn_slices(self) -> None:
        """Boot only: re-learn every stamped slice world and epoch from the
        specs before any repair runs (module docstring)."""
        for _key, info in list(self._storage.items()):
            for by_resource in list(info.allocations.values()):
                try:
                    stamped = self._slices.stamped_view(by_resource)
                except Exception:  # noqa: BLE001 - best-effort pre-learn
                    continue
                if stamped is not None:
                    self._slices.observe(stamped)

    def _reconcile_slices(self, report: dict, boot: bool,
                          active: bool) -> None:
        """For every bound pod carrying a slice stamp, diff the hosts in
        its specs against the apiserver's live members; a divergence seen
        on two passes, the second from a fresh LIST, re-forms the member
        (``SliceReformer.reform``)."""
        from .common import AnnotationSliceID
        from .slices.recovery import SliceMembershipError

        seen_slices: set = set()
        local_members: Dict[str, set] = {}  # slice -> pod keys seen bound
        live_cache: Dict[str, set] = {}  # one apiserver view a pass
        for _key, info in list(self._storage.items()):
            pod = self._sitter.get_pod(info.namespace, info.name)
            ann = ((pod or {}).get("metadata", {}).get("annotations", {})
                   or {})
            slice_id = ann.get(AnnotationSliceID, "")
            if slice_id:
                seen_slices.add(slice_id)
            for container, by_resource in list(info.allocations.items()):
                if pod is not None and not slice_id:
                    # the live pod carries no slice annotation: not a
                    # member, and no spec is read for it
                    continue
                # The stamped spec is the durable membership record: read
                # and re-learned even while the sitter cannot return the
                # pod, so that a watch blip never prunes a live slice.
                stamped = self._slices.stamped_view(by_resource)
                if stamped is None:
                    continue  # unstamped: nothing to diff or reform yet
                seen_slices.add(stamped[0])
                local_members.setdefault(stamped[0], set()).add(info.key)
                self._slices.observe(stamped)
                if pod is None:
                    continue  # dead or unknown pods are the record walk's
                stamped_slice = stamped[0]
                owner = PodContainer(info.namespace, info.name, container)
                try:
                    div = self._slices.divergence(
                        owner, by_resource, live_hosts_cache=live_cache,
                        stamped=stamped)
                except SliceMembershipError as e:
                    # unknowable is never loss: reported, retried
                    report["slice_check_errors"] += 1
                    logger.warning(
                        "reconcile: slice membership for %s unknowable: "
                        "%s", stamped_slice, e)
                    continue
                if div is None:
                    continue
                skey = ("slice", stamped_slice, owner.pod_key, container,
                        tuple(div["new_hosts"]))
                if not active:
                    self._candidate(skey)
                    report["divergences_observed"] += 1
                    continue
                if not boot and not self._confirmed(skey):
                    # first sighting: a member mid-registration (or a
                    # watch blip) must not re-form the slice
                    continue
                if not boot:
                    # The confirming sighting comes from an independent
                    # LIST: with a period shorter than the membership
                    # TTL, two passes could read one snapshot.
                    try:
                        fresh = {stamped_slice:
                                 self._slices.registry.live_hosts(
                                     stamped_slice, refresh=True)}
                    except SliceMembershipError as e:
                        report["slice_check_errors"] += 1
                        logger.warning(
                            "reconcile: slice %s reform confirmation "
                            "blocked, membership unknowable: %s",
                            stamped_slice, e)
                        continue
                    live_cache.update(fresh)
                    div = self._slices.divergence(
                        owner, by_resource, live_hosts_cache=fresh,
                        stamped=stamped)
                    if div is None:
                        continue  # healthy on the fresh view after all
                    fresh_skey = ("slice", stamped_slice, owner.pod_key,
                                  container, tuple(div["new_hosts"]))
                    if fresh_skey != skey:
                        # the world moved between sightings: confirm the
                        # new shape from scratch
                        self._candidate(fresh_skey)
                        continue
                try:
                    self._slices.reform(owner, by_resource, div)
                    # the reformer journals the richer slice_reformed row
                    # itself: a second row would read as a second reform
                    self._count(report, KIND_SLICE_REFORMED, emit=False)
                except Exception as e:  # noqa: BLE001 - retried next pass
                    logger.warning(
                        "reconcile: slice reform for %s (%s) failed: %s",
                        owner.pod_key, stamped_slice, e)
                    report["slice_reform_failures"] += 1
                    with self._lock:
                        self._slice_reform_failures_total += 1
        if active:
            # dry-run passes observe only: a prune moves registry state
            registry = self._slices.registry
            registry.prune(seen_slices)
            # a reclaimed member (its record gone) leaves the slice's
            # local members, re-checked per pod so that a bind landing
            # mid-pass stays
            for sid, st in registry.status().items():
                for pod_key in list(st.get("local_pods", {})):
                    if pod_key in local_members.get(sid, ()):
                        continue
                    ns, _, name = pod_key.partition("/")
                    if self._storage.load(ns, name) is None:
                        registry.drop_local_pod(sid, pod_key)

    # -- CRD inventory (boot only, as restore() always did) -------------------

    def _reconcile_crd(self) -> None:
        live = [
            record.device.hash
            for _, info in self._storage.items()
            for record in info.records()
        ]
        try:
            chips = [c.index for c in self._operator.devices()]
        except Exception:  # noqa: BLE001 - discovery failure
            chips = []
        with get_tracer().span("crd_reconcile", live=len(live)):
            try:
                self._crd.reconcile(live, chip_indexes=chips)
            except Exception:  # noqa: BLE001 - observability, never fatal
                logger.exception("reconcile: CRD sweep failed")

    # -- the supervised loop --------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        """Supervised loop: jittered pacing around ``period_s`` (0.75x -
        1.25x, so a fleet of agents never thunders onto the kubelet in
        lockstep after a node-pool-wide restart).

        With an event bus the wait doubles as an event trigger: bus
        events start a targeted pass immediately (debounced), and the
        periodic sweep stretches to ``period_s x
        event_safety_net_factor`` while the bus is healthy — unless the
        LAST pass left work outstanding (pending confirmations,
        failures, observed divergences), in which case the next sweep
        comes at the base period regardless (two-pass confirmation must
        never wait out a stretched safety net)."""
        consecutive_failures = 0
        last_event_pass = 0.0
        outstanding = False
        while True:
            # Evidence lives for exactly one pass: cleared before the
            # wait, set only when this iteration drains store-delete
            # notifications.
            self._event_evidence = set()
            factor = 1.0
            sub = self._event_sub
            if (
                sub is not None and not outstanding
                and self._bus.healthy()
            ):
                factor = self.event_safety_net_factor
            delay = self.period_s * factor * (
                0.75 + 0.5 * self._rng.random()
            )
            if sub is None:
                if stop.wait(delay):
                    return
                trigger = "poll"
            else:
                trigger = sub.wait_trigger(stop, delay)
                if trigger == "stop":
                    return
                if trigger == "event":
                    # Debounce the burst, and pace event-triggered
                    # passes at least EVENT_MIN_INTERVAL_S apart.
                    since = time.monotonic() - last_event_pass
                    pace = max(EVENT_DEBOUNCE_S,
                               EVENT_MIN_INTERVAL_S - since)
                    if stop.wait(pace):
                        return
                    drained = sub.drain()
                    last_event_pass = time.monotonic()
                    if drained and all(
                        e.topic == bus_events.BUS_WAKE for e in drained
                    ):
                        # Pure bus-health wake (watch died/recovered):
                        # run the sweep NOW at poll attribution — the
                        # no-gap fallback — and recompute the stretch
                        # on the next iteration.
                        trigger = "poll"
                    else:
                        with self._lock:
                            self._event_passes_total += 1
                        # A store-delete notification is commit-ordered
                        # proof the pod's record is GONE — not an
                        # in-flight bind racing the kubelet List — so
                        # the pass it triggers may replay that pod
                        # without the two-pass confirmation wait.
                        self._event_evidence = {
                            e.key for e in drained
                            if e.topic == bus_events.STORE_BIND
                            and e.kind == "delete"
                        }
            with get_tracer().trace("reconcile") as tr:
                try:
                    report = self.reconcile_once(trigger=trigger)
                    consecutive_failures = 0
                    outstanding = bool(
                        report["pending_confirmation"]
                        or report["sweep_failures"]
                        or report["replay_failures"]
                        or report["divergences_observed"]
                    )
                except Exception as e:  # noqa: BLE001
                    # One-off failures (apiserver blip, transient sqlite
                    # lock) are absorbed without burning a supervisor
                    # restart; a PERSISTENTLY failing pass must escape to
                    # the supervisor — otherwise the node silently loses
                    # all self-repair while /healthz reads healthy.
                    consecutive_failures += 1
                    outstanding = True  # failed pass: retry at base period
                    with self._lock:
                        self._last_error = f"{type(e).__name__}: {e}"
                    if consecutive_failures >= 3:
                        raise
                    logger.exception(
                        "reconcile pass failed (%d consecutive; "
                        "escalating to the supervisor at 3)",
                        consecutive_failures,
                    )
                    continue
                repaired = report["repaired_total"]
                tr.set(
                    repaired=repaired,
                    observed=report["divergences_observed"],
                    sweep_failures=report["sweep_failures"],
                    replay_failures=report["replay_failures"],
                )
                if (
                    repaired == 0
                    and report["sweep_failures"] == 0
                    and report["replay_failures"] == 0
                    and report["divergences_observed"] == 0
                ):
                    # TRULY quiet passes run forever; don't churn real
                    # allocation traces out of the bounded ring. Dry-run
                    # observations and failing replays ARE the signal —
                    # they must stay visible in /debug/traces.
                    tr.discard()

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        """Last run, per-class repair totals, and every open (uncommitted)
        bind intent with its age: a stuck intent must be diagnosable from
        this alone."""
        try:
            intents = self._storage.open_intents_brief()
        except Exception:  # noqa: BLE001 - storage may already be closed
            intents = []
        sub = self._event_sub
        events_block = None
        if sub is not None:
            events_block = {
                "safety_net_factor": self.event_safety_net_factor,
                "bus_healthy": self._bus.healthy(),
                "subscription": sub.stats(),
            }
        with self._lock:
            if events_block is not None:
                events_block["event_passes_total"] = (
                    self._event_passes_total
                )
            return {
                "period_s": self.period_s,
                "events": events_block,
                "dry_run": self.dry_run,
                "runs_total": self._runs_total,
                "last_run_ts": self._last_run_ts,
                "last_duration_s": self._last_duration_s,
                "last_converged_ts": self._last_converged_ts,
                "repairs_total": {
                    k: v for k, v in self._repairs.items() if v
                },
                "sweep_failures_total": self._sweep_failures_total,
                "replay_failures_total": self._replay_failures_total,
                "slice_reform_failures_total": (
                    self._slice_reform_failures_total),
                "last_error": self._last_error,
                "pending_confirmation": len(self._prev_candidates),
                "open_intents": intents,
                "last_report": dict(self._last_report),
            }
