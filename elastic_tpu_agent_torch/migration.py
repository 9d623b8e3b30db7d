"""Migration coordinator: the agent's half of the checkpoint handshake.

The port's copy of ``elastic_tpu_agent/migration.py``; the pod's half is
``workloads/lifecycle.py``. The coordinator consumes the atomic ack files
workloads write (``<alloc dir>/ack/<hash>.json``: checkpoint step,
directory digest, wall time) to:

- **complete drains early**: a Draining resident whose ack is durable is
  reclaimed the moment its checkpoint lands instead of at the deadline;
  an un-acked resident keeps the whole deadline;
- **drive pre-copy**: a resident that streams delta rounds
  (``kind="precopy"`` acks) trains on while the rounds are journaled; at
  the round cap (16), when the delta stops shrinking (a round at 0.9 of
  the previous or more) or when the last 0.25 of the drain budget begins,
  the coordinator stamps ``ELASTIC_TPU_CUTOVER`` and the workload ships
  the final delta and acks;
- **publish a MigrationRecord** (pod, checkpoint location, step, digest,
  topology env, trace id) as an ElasticTPU object in phase ``Migrated``,
  so that the replacement pod, wherever it lands, restores from it;
- **verify the resume** on the destination: the agent that binds the
  replacement stamps ``ELASTIC_TPU_RESTORE_DIR``/``_STEP`` into its specs,
  waits for the workload's ``kind="resume"`` ack, checks step >= the acked
  step and world size == the spec's current world (and, for a pre-copy
  record, the delta chain), then posts ``TPUMigrationCompleted`` and a
  ``migration`` timeline row keyed to the source bind's trace id.

The agent's process must not import torch, and the pod side's modules do
(``workloads/__init__.py``): this module keeps its own copies of what it
reads of them (``read_checkpoint_ack``, ``world_size_of``, the delta
chain's verification), which tests hold equal to the pod side's.

Records, the replay-suppression set and the inbound state are journaled
(the store's ``save_state``) before their side effects (the crash windows
``migration.pre_ack`` and ``migration.post_record``); :meth:`resume`
re-arms them before the boot reconcile, and every step is idempotent.
Supervised DEGRADED: without the coordinator drains run to their deadline.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from . import faults
from .common import (
    SYSTEM_CLOCK,
    AckSubdir,
    EnvCutover,
    EnvRestoreDir,
    EnvRestoreStep,
    EnvRestoreTrace,
    EnvSliceEpoch,
    EnvSliceName,
)
from .types import PodContainer

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_S = 2.0
# Pre-copy round cap: a workload whose delta never converges still cuts
# over well before the deadline.
DEFAULT_PRECOPY_MAX_ROUNDS = 16
# Share of the drain budget kept for the cutover itself (pause, final
# delta, reclaim).
DEFAULT_PRECOPY_CUTOVER_MARGIN_FRAC = 0.25
# A delta round at this share of the previous one or more: pre-copy has
# converged, cut over while the delta is small.
PRECOPY_CONVERGED_RATIO = 0.9
# How long a bound pod's "is there a record for me?" miss stays cached.
DEFAULT_RECORD_RECHECK_S = 15.0
# Consumed acks kept (outcome classification, the age gauge) after their
# files went with the spec; pruned oldest first past this.
MAX_RETAINED_ACKS = 1024

_STATE_KEY = "migration"

# Topology env a record snapshots from the source spec: what a reader
# needs to judge whether the workload came back at a sane world.
_TOPOLOGY_KEYS = (
    "TPU_WORKER_ID",
    "TPU_WORKER_HOSTNAMES",
    EnvSliceName,
    EnvSliceEpoch,
)

# The delta-checkpoint layout of workloads/checkpointing.py
# (DeltaCheckpointer): content-addressed blocks and per-round manifests
# chained by blake2b.
_DELTA_DIGEST_SIZE = 16
_DELTA_CHAIN_ROOT = b"\x00" * _DELTA_DIGEST_SIZE
_MANIFEST_PREFIX = "manifest-"


def migration_object_name(namespace: str, name: str) -> str:
    """The record's object name for one workload identity, the same on
    the source and the destination (the rendezvous): a readable prefix cut
    under the apiserver's 253-character cap, and the crc of the
    unambiguous "ns/name" key ("team-a"/"x" and "team"/"a-x" share the
    prefix)."""
    key = f"{namespace}/{name}"
    crc = zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF
    return f"{f'mig-{namespace}-{name}'[:240]}-{crc:08x}"


def read_checkpoint_ack(alloc_spec_dir: str,
                        alloc_hash: str) -> Optional[dict]:
    """The pod's newest ack, or None when absent or torn (the agent-side
    copy of ``workloads/lifecycle.read_checkpoint_ack``)."""
    try:
        with open(os.path.join(
            alloc_spec_dir, AckSubdir, f"{alloc_hash}.json"
        )) as f:
            ack = json.load(f)
    except (OSError, ValueError):
        return None
    return ack if isinstance(ack, dict) else None


def world_size_of(env: Dict[str, str]) -> int:
    """The slice world size a spec env describes (the hosts in
    ``TPU_WORKER_HOSTNAMES``, 1 when unset; the agent-side copy of
    ``workloads/lifecycle.world_size_of``)."""
    hosts = [h for h in (env.get("TPU_WORKER_HOSTNAMES") or "").split(",")
             if h]
    return max(1, len(hosts))


def _chain(digests: List[str]) -> str:
    """``chain_j = H(chain_{j-1} || digest_j)`` over the block digests."""
    chain = _DELTA_CHAIN_ROOT
    for d in digests:
        h = hashlib.blake2b(digest_size=_DELTA_DIGEST_SIZE)
        h.update(chain)
        h.update(bytes.fromhex(d))
        chain = h.digest()
    return chain.hex()


def _read_manifest(directory: str, step: int) -> Optional[dict]:
    try:
        with open(os.path.join(
            directory, f"{_MANIFEST_PREFIX}{int(step):012d}.json"
        )) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    return m if isinstance(m, dict) and "blocks" in m else None


def verify_delta_chain(directory: str) -> Dict:
    """Verify the newest readable delta round under ``directory``: every
    block present, each block's content equal to its digest, and the
    recomputed chain equal to the manifest's: ``{"ok", "chain",
    "problems", ...}``, as ``DeltaCheckpointer(directory).verify()``."""
    best = None
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in names:
        if not (name.startswith(_MANIFEST_PREFIX) and name.endswith(".json")):
            continue
        try:
            step = int(name[len(_MANIFEST_PREFIX):-len(".json")])
        except ValueError:
            continue
        if (best is None or step > best) and _read_manifest(
                directory, step) is not None:
            best = step
    if best is None:
        return {"ok": False, "problems": ["no manifest present"]}
    m = _read_manifest(directory, best)
    problems: List[str] = []
    for d in m["blocks"]:
        try:
            with open(os.path.join(directory, "blocks", f"{d}.bin"),
                      "rb") as f:
                data = f.read()
        except OSError:
            problems.append(f"block {d} missing")
            continue
        if hashlib.blake2b(
            data, digest_size=_DELTA_DIGEST_SIZE
        ).hexdigest() != d:
            problems.append(f"block {d} corrupt")
    chain = _chain(m["blocks"])
    if chain != m.get("chain"):
        problems.append(
            f"chain mismatch: recomputed {chain}, manifest {m.get('chain')}"
        )
    return {
        "ok": not problems,
        "step": int(best),
        "chain": chain,
        "n_blocks": len(m["blocks"]),
        "total_bytes": m.get("total_bytes"),
        "problems": problems,
    }


class MigrationCoordinator:
    """The migration handshake of one node (one per agent): the
    source role (consume acks, drive pre-copy, publish records, reclaim
    early) and the destination role (stamp the restore env, verify the
    resume) run on the same supervised tick."""

    def __init__(
        self,
        storage,
        plugin,
        sitter,
        reconciler,
        drain=None,
        kube_client=None,
        crd_recorder=None,
        events=None,
        metrics=None,
        node_name: str = "",
        alloc_spec_dir: str = "",
        period_s: float = DEFAULT_PERIOD_S,
        record_recheck_s: float = DEFAULT_RECORD_RECHECK_S,
        precopy_max_rounds: int = DEFAULT_PRECOPY_MAX_ROUNDS,
        precopy_cutover_margin_frac: float = (
            DEFAULT_PRECOPY_CUTOVER_MARGIN_FRAC
        ),
        rng=None,
        timeline=None,
        clock=None,
        lag_tracker=None,
        bus=None,
        event_safety_net_factor: float = 1.0,
    ) -> None:
        self._storage = storage
        self._plugin = plugin
        self._sitter = sitter
        self._reconciler = reconciler
        self._drain = drain
        self._client = kube_client
        self._crd_recorder = crd_recorder
        self._crd = None
        if kube_client is not None:
            from .crd import ElasticTPUClient

            self._crd = ElasticTPUClient(kube_client)
        self._events = events
        self._metrics = metrics
        self._node = node_name
        self._alloc_dir = alloc_spec_dir
        self.period_s = period_s
        self.record_recheck_s = record_recheck_s
        self.precopy_max_rounds = max(1, int(precopy_max_rounds))
        self.precopy_cutover_margin_frac = max(
            0.0, min(0.9, float(precopy_cutover_margin_frac))
        )
        self._rng = rng if rng is not None else random.Random()
        self._timeline = timeline
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        # DetectionLagTracker (latency.py): a new ack's "ts" is its origin
        self._lag = lag_tracker
        self._lock = threading.Lock()
        # pod_key -> record (source role), journaled
        self._records: Dict[str, dict] = {}
        # pod_key -> uid: early-reclaimed pods whose kubelet assignments
        # must not be replayed until the pod is gone
        self._migrated: Dict[str, str] = {}
        # pod_key -> newest consumed ack ts, kept past the files' reclaim
        # for the drain's outcome
        self._acked: Dict[str, float] = {}
        # pod_key -> newest consumed ack (the status block)
        self._last_acks: Dict[str, dict] = {}
        # pod_key -> inbound verification (destination role), journaled:
        # {"record", "stage": restamped, "restamp_ts"}
        self._inbound: Dict[str, dict] = {}
        # pod_key -> pre-copy stream (source role), journaled: {"rounds",
        # "stage": streaming|cutover, "started_ts", "cutover_ts",
        # "cutover_reason"}; a restart goes on where it stood
        self._precopy: Dict[str, dict] = {}
        # Destination discovery is one LIST of the records a tick at most,
        # and only while an unresolved resident needs a snapshot newer
        # than its first sighting (a record always exists before its
        # replacement can be scheduled); one delayed second look after
        # record_recheck_s covers the sink's stragglers.
        self._records_snapshot: Dict[tuple, tuple] = {}
        self._records_snapshot_ts: Optional[float] = None
        self._first_seen: Dict[str, float] = {}
        self._resolve_attempts: Dict[str, tuple] = {}
        self._early_reclaims_total = 0
        self._records_published_total = 0
        self._completed_total = 0
        self._precopy_rounds_total = 0
        self._cutovers_total = 0
        self._verify_failures_total = 0
        self._completed: List[dict] = []  # bounded recent completions
        self._last_error: Optional[str] = None
        self._resumed = False
        # With an event bus, pod deltas, bind commits and the drain's
        # state writes wake a tick; the sweep stretches only while the
        # handshake is quiet, as acks arrive as files no event carries.
        self._bus = bus
        self.event_safety_net_factor = max(1.0, float(
            event_safety_net_factor))
        self._event_sub = None
        if bus is not None:
            from . import events as bus_events

            self._event_sub = bus.subscribe(
                "migration",
                (bus_events.POD_DELTA, bus_events.STORE_BIND,
                 bus_events.STORE_STATE),
            )
        self.event_ticks_total = 0

    # -- journaled state ------------------------------------------------------

    def _journal_locked(self) -> None:
        self._storage.save_state(_STATE_KEY, {
            "records": {k: dict(v) for k, v in self._records.items()},
            "migrated": dict(self._migrated),
            "acked": dict(self._acked),
            "inbound": {k: dict(v) for k, v in self._inbound.items()},
            "precopy": {k: dict(v) for k, v in self._precopy.items()},
            "early_reclaims_total": self._early_reclaims_total,
            "records_published_total": self._records_published_total,
            "completed_total": self._completed_total,
            "precopy_rounds_total": self._precopy_rounds_total,
            "cutovers_total": self._cutovers_total,
        })

    def resume(self) -> None:
        """Re-arm the journaled state after a restart, before the boot
        reconcile (replay suppression must be up before restore() walks
        the kubelet's assignments, and half-published records finish).
        Idempotent."""
        try:
            st = self._storage.load_state(_STATE_KEY)
        except Exception:  # noqa: BLE001 - unreadable journal: start clean
            logger.exception("migration: state journal unreadable; "
                             "starting clean")
            st = None
        if st:
            with self._lock:
                self._records = {
                    k: dict(v) for k, v in (st.get("records") or {}).items()
                }
                self._migrated = dict(st.get("migrated") or {})
                self._acked = {
                    k: float(v) for k, v in (st.get("acked") or {}).items()
                }
                self._inbound = {
                    k: dict(v) for k, v in (st.get("inbound") or {}).items()
                }
                self._precopy = {
                    k: dict(v) for k, v in (st.get("precopy") or {}).items()
                }
                self._early_reclaims_total = int(
                    st.get("early_reclaims_total", 0))
                self._records_published_total = int(
                    st.get("records_published_total", 0))
                self._completed_total = int(st.get("completed_total", 0))
                self._precopy_rounds_total = int(
                    st.get("precopy_rounds_total", 0))
                self._cutovers_total = int(st.get("cutovers_total", 0))
            if self._records or self._migrated or self._inbound:
                logger.warning(
                    "migration: resumed %d record(s), %d suppressed "
                    "pod(s), %d inbound verification(s)",
                    len(self._records), len(self._migrated),
                    len(self._inbound),
                )
        self._resumed = True

    # -- hooks of the reconciler and the drain --------------------------------

    def replay_suppressed(self, pod_key: str) -> bool:
        """True while ``pod_key``'s early-reclaimed bindings must stay
        reclaimed (the kubelet lists the assignment until eviction)."""
        with self._lock:
            return pod_key in self._migrated

    def acked_since(self, pod_key: str, since_ts: Optional[float]) -> bool:
        """Whether the pod acked a durable checkpoint at or after
        ``since_ts`` (None: ever); the drain's outcome reads it."""
        with self._lock:
            ts = self._acked.get(pod_key)
        if ts is None:
            return False
        return since_ts is None or ts >= since_ts

    def acked_pods(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._acked)

    # -- ack consumption (source role) ----------------------------------------

    def _residents(self) -> Optional[List[Tuple[str, dict]]]:
        """[(pod_key, {"namespace", "name", "containers": {container:
        records}, "hashes"})] for every pod this node holds bindings for;
        None when the store cannot answer."""
        out: List[Tuple[str, dict]] = []
        try:
            items = list(self._storage.items())
        except Exception:  # noqa: BLE001 - storage blip: retry next tick
            logger.exception("migration: resident enumeration failed")
            return None
        for _key, info in items:
            hashes = [rec.device.hash for rec in info.records()]
            if not hashes:
                continue
            out.append((info.key, {
                "namespace": info.namespace,
                "name": info.name,
                "containers": {
                    c: dict(r) for c, r in info.allocations.items() if r
                },
                "hashes": hashes,
            }))
        return out

    def _spec_env(self, hashes: List[str]) -> Dict[str, str]:
        for h in hashes:
            spec = self._plugin.core.read_alloc_spec(h)
            if spec and isinstance(spec.get("env"), dict):
                return dict(spec["env"])
        return {}

    def _read_ack(self, hashes: List[str]) -> Optional[dict]:
        for h in hashes:
            ack = read_checkpoint_ack(self._alloc_dir, h)
            if ack is not None:
                return ack
        return None

    def _consume_acks(self, residents) -> Dict[str, dict]:
        """Read every resident's ack; update the retained ack map and the
        checkpoint-age gauge. Returns pod_key -> ack."""
        now = self._clock.time()
        acks: Dict[str, dict] = {}
        for pod_key, res in residents:
            ack = self._read_ack(res["hashes"])
            if ack is None:
                continue
            try:
                ts = float(ack.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if ts > now + 60.0:
                # a future-stamped ack (a skewed clock) must not pin "just
                # checkpointed" forever
                continue
            acks[pod_key] = ack
            with self._lock:
                if ack.get("kind") == "precopy":
                    # a pre-copy round is progress, not a restorable
                    # cutover point: it never feeds _acked
                    self._last_acks[pod_key] = ack
                    fresh = False
                else:
                    fresh = ts > self._acked.get(pod_key, 0.0)
                    self._acked[pod_key] = max(
                        ts, self._acked.get(pod_key, 0.0))
                    self._last_acks[pod_key] = ack
                while len(self._acked) > MAX_RETAINED_ACKS:
                    oldest = min(self._acked, key=self._acked.get)
                    self._acked.pop(oldest, None)
                    self._last_acks.pop(oldest, None)
            if self._lag is not None and fresh:
                self._lag.handled(
                    "migration", "checkpoint_ack", key=pod_key,
                    origin_ts=ts,
                )
            if self._metrics is not None:
                self._metrics.workload_checkpoint_age.set(
                    max(0.0, now - ts), pod=pod_key)
        return acks

    # -- records --------------------------------------------------------------

    def _build_record(
        self, pod_key: str, res: dict, ack: dict, reason: str
    ) -> dict:
        env = self._spec_env(res["hashes"])
        pod = self._sitter.get_pod(res["namespace"], res["name"])
        uid = str(((pod or {}).get("metadata") or {}).get("uid", ""))
        record = {
            "name": migration_object_name(res["namespace"], res["name"]),
            "pod": pod_key,
            "uid": uid,
            "source_node": self._node,
            "reason": reason,
            "step": ack.get("step"),
            "checkpoint_dir": ack.get("checkpoint_dir", ""),
            "digest": ack.get("digest", ""),
            "ack_kind": ack.get("kind", "checkpoint"),
            "ack_ts": ack.get("ts"),
            "trace": env.get("ELASTIC_TPU_TRACE_ID", ""),
            "topology_env": {
                k: env[k] for k in _TOPOLOGY_KEYS if k in env
            },
            "recorded_ts": self._clock.time(),
            "published": False,
            "reclaimed": False,
        }
        with self._lock:
            pc = self._precopy.get(pod_key)
        if pc is not None:
            # the cutover ack closed a pre-copy stream: the digest is the
            # delta chain the destination must verify
            record["mode"] = "precopy"
            record["precopy"] = {
                "rounds": len(pc.get("rounds") or []),
                "started_ts": pc.get("started_ts"),
                "cutover_ts": pc.get("cutover_ts"),
                "cutover_reason": pc.get("cutover_reason"),
                "final_delta_bytes": ack.get("delta_bytes"),
                "full_bytes": ack.get("full_bytes")
                or ack.get("total_bytes"),
                "cutover_ms": ack.get("cutover_ms"),
            }
        return record

    def _record_manifest(self, record: dict):
        from .crd import ElasticTPU, PhaseMigrated

        ns, _, name = record["pod"].partition("/")
        return ElasticTPU(
            name=record["name"],
            # no node name: the recorder's restore sweep removes this
            # node's objects that are not live allocations, and a record
            # must outlive the source's bindings
            node_name="",
            claim_namespace=ns,
            claim_name=name,
            phase=PhaseMigrated,
            message=(
                f"checkpoint step {record['step']} at "
                f"{record['checkpoint_dir'] or '<unset>'} "
                f"(from {record['source_node']}, {record['reason']})"
            ),
            migration={
                k: record[k] for k in (
                    "pod", "uid", "source_node", "reason", "step",
                    "checkpoint_dir", "digest", "ack_kind", "ack_ts",
                    "trace", "topology_env", "recorded_ts", "mode",
                    "precopy",
                ) if k in record
            },
        )

    def _emit(self, pod_key: str, trace=None, **attrs) -> None:
        """One ``migration`` timeline row keyed by the pod and the source
        bind's trace id (``trace=None``: the thread's trace, as the
        timeline fills it in)."""
        if self._timeline is not None:
            from .timeline import KIND_MIGRATION

            keys = {"pod": pod_key}
            if trace is not None:
                keys["trace"] = trace or None
            self._timeline.emit(KIND_MIGRATION, keys=keys, **attrs)

    def _publish_pending(self) -> None:
        """Publish every journaled record not yet confirmed at the
        apiserver, re-submitted each tick until a read-back sees it: the
        journal is the durable copy."""
        if self._crd is None:
            return
        with self._lock:
            pending = [
                dict(r) for r in self._records.values()
                if not r.get("published")
            ]
        for record in pending:
            try:
                existing = self._crd.get(record["name"])
            except Exception:  # noqa: BLE001 - apiserver blip: next tick
                continue
            if existing is not None and (
                (existing.migration or {}).get("ack_ts") == record["ack_ts"]
            ):
                confirmed = True
            else:
                obj = self._record_manifest(record)
                if self._crd_recorder is not None:
                    # the async sink; confirmed by read-back next tick
                    self._crd_recorder.record_migration(obj)
                    confirmed = False
                else:
                    try:
                        self._crd.create(obj, update_existing=True)
                        confirmed = True
                    except Exception:  # noqa: BLE001 - retried next tick
                        logger.warning(
                            "migration: record publish for %s failed "
                            "(retried)", record["pod"],
                        )
                        continue
            if confirmed:
                with self._lock:
                    rec = self._records.get(record["pod"])
                    if rec is not None and not rec.get("published"):
                        rec["published"] = True
                        self._records_published_total += 1
                        self._journal_locked()
                if self._metrics is not None:
                    self._metrics.migration_records.inc()
                self._emit(record["pod"], record["trace"],
                           action="record_published", step=record["step"],
                           checkpoint_dir=record["checkpoint_dir"],
                           reason=record["reason"])

    def publish_record(
        self, pod_key: str, uid: str = "", reason: str = "qos_evict"
    ) -> bool:
        """Journal and queue a record for ``pod_key`` from its newest
        consumed ack, without reclaiming (the caller owns the teardown).
        True when a record exists afterwards. Never raises."""
        try:
            with self._lock:
                if pod_key in self._records:
                    return True
                ack = self._last_acks.get(pod_key)
            if ack is None:
                return False
            residents = self._residents() or []
            res = dict(residents).get(pod_key)
            if res is None:
                return False
            record = self._build_record(pod_key, res, ack, reason)
            if uid and not record["uid"]:
                record["uid"] = uid
            with self._lock:
                self._records[pod_key] = record
                self._journal_locked()
            self._emit_recorded(record)
            self._publish_pending()
            return True
        except Exception:  # noqa: BLE001 - a gate must never break eviction
            logger.exception("migration: publish_record(%s) failed", pod_key)
            return False

    def _emit_recorded(self, record: dict) -> None:
        self._emit(record["pod"], record["trace"], action="recorded",
                   step=record["step"],
                   checkpoint_dir=record["checkpoint_dir"],
                   digest=record["digest"], reason=record["reason"],
                   mode=record.get("mode", "full"),
                   cutover_ts=(record.get("precopy") or {}).get(
                       "cutover_ts"))
        if self._events is not None:
            from .kube.events import ReasonMigrationRecorded

            ns, _, name = record["pod"].partition("/")
            try:
                self._events.pod_event(
                    ns, name, ReasonMigrationRecorded,
                    f"checkpoint verified durable at step "
                    f"{record['step']} ({record['reason']}); migration "
                    "record published for the replacement pod",
                    trace_id=record["trace"],
                )
            except Exception:  # noqa: BLE001 - observability only
                pass

    # -- pipelined pre-copy (source role) -------------------------------------

    def _cutover_reason(self, pc: dict, now: float) -> Optional[str]:
        """Why this stream should cut over now (None: keep streaming):
        the round cap, the delta converged (it stopped shrinking), or the
        cutover margin of the drain budget has come."""
        rounds = pc.get("rounds") or []
        if len(rounds) >= self.precopy_max_rounds:
            return "rounds"
        if len(rounds) >= 3:
            # round 0 ships the full baseline: judge delta against delta
            try:
                last = float(rounds[-1].get("delta_bytes") or 0.0)
                prev = float(rounds[-2].get("delta_bytes") or 0.0)
            except (TypeError, ValueError):
                last = prev = 0.0
            if prev > 0.0 and last >= PRECOPY_CONVERGED_RATIO * prev:
                return "converged"
        drain = self._drain
        deadline_ts = getattr(drain, "deadline_ts", None)
        if deadline_ts:
            started = drain.started_ts()
            budget = max(0.0, deadline_ts - (
                started if started is not None else now))
            margin = self.precopy_cutover_margin_frac * budget
            if now >= deadline_ts - margin:
                return "deadline"
        return None

    def _restamp(self, pod_key: str, res: dict, env: Dict[str, str],
                 what: str) -> bool:
        """``env`` into every container's specs of the pod; True when a
        spec carries it."""
        from .plugins import restamp_owner_env

        ok = False
        for container, records in res["containers"].items():
            owner = PodContainer(res["namespace"], res["name"], container)
            try:
                if restamp_owner_env(self._plugin.core, owner, records, env):
                    ok = True
            except Exception:  # noqa: BLE001 - retried next tick
                logger.exception("migration: %s stamp for %s failed",
                                 what, pod_key)
        return ok

    def _stamp_cutover(self, pod_key: str, res: dict, pc: dict) -> bool:
        """``ELASTIC_TPU_CUTOVER``, the signal that ends streaming. The
        token carries reason, round and time, so that a new drain's stream
        is a new edge on the workload's side; re-asserted every tick until
        the final ack lands."""
        token = (
            f"{pc.get('cutover_reason', 'cutover')}:"
            f"{len(pc.get('rounds') or [])}:"
            f"{pc.get('cutover_ts') or 0:.3f}"
        )
        return self._restamp(pod_key, res, {EnvCutover: token}, "cutover")

    def _precopy_pass(self, residents, acks: Dict[str, dict]) -> None:
        """While the node drains: journal each round a workload streams
        (it trains on), decide the cutover, then stamp it until the final
        ack arrives and the early-reclaim pass takes over. A workload that
        never streams is never in this map."""
        from .drain import DRAINING

        drain = self._drain
        if drain is None or drain.state != DRAINING:
            with self._lock:
                if self._precopy:
                    # a cancelled or finished drain ends its streams
                    self._precopy.clear()
                    self._journal_locked()
            return
        started = drain.started_ts()
        now = self._clock.time()
        by_key = dict(residents)
        for pod_key, ack in acks.items():
            if ack.get("kind") != "precopy":
                continue
            res = by_key.get(pod_key)
            if res is None:
                continue
            try:
                ts = float(ack.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if started is not None and ts < started:
                continue  # a stream of an earlier drain
            try:
                round_ = int(ack.get("round", 0))
            except (TypeError, ValueError):
                round_ = 0
            with self._lock:
                pc = self._precopy.get(pod_key)
                pc = dict(pc) if pc is not None else {
                    "rounds": [],
                    "stage": "streaming",
                    "started_ts": ts,
                    "trigger": drain.trigger,
                    "cutover_ts": None,
                    "cutover_reason": None,
                }
            if pc["stage"] != "cutover" and round_ not in {
                r.get("round") for r in pc["rounds"]
            }:
                faults.fire("migration.pre_copy_round")
                pc["rounds"] = (pc["rounds"] + [{
                    "round": round_,
                    "step": ack.get("step"),
                    "delta_bytes": ack.get("delta_bytes"),
                    "total_bytes": ack.get("total_bytes"),
                    "chain": ack.get("digest", ""),
                    "ts": ts,
                }])[-64:]
                with self._lock:
                    self._precopy[pod_key] = pc
                    self._precopy_rounds_total += 1
                    self._journal_locked()  # the round before effects
                faults.fire("migration.pre_copy_journal")
                self._emit(pod_key, action="precopy_round",
                           round=round_, step=ack.get("step"),
                           delta_bytes=ack.get("delta_bytes"),
                           total_bytes=ack.get("total_bytes"))
                logger.warning(
                    "migration: %s pre-copy round %d durable (step %s, "
                    "%s delta bytes); training continues",
                    pod_key, round_, ack.get("step"),
                    ack.get("delta_bytes"),
                )
            if pc["stage"] != "cutover":
                reason = self._cutover_reason(pc, now)
                if reason is not None:
                    pc["stage"] = "cutover"
                    pc["cutover_ts"] = now
                    pc["cutover_reason"] = reason
                    with self._lock:
                        self._precopy[pod_key] = pc
                        self._cutovers_total += 1
                        self._journal_locked()  # before the stamp
                    faults.fire("migration.pre_copy_cutover")
                    self._emit(pod_key, action="cutover_signaled",
                               reason=reason, rounds=len(pc["rounds"]),
                               deadline_ts=drain.deadline_ts)
                    logger.warning(
                        "migration: %s pre-copy cutover (%s) after %d "
                        "round(s); pause + final delta requested",
                        pod_key, reason, len(pc["rounds"]),
                    )
        # re-assert the stamp of every stream in cutover: idempotent, and
        # it covers drift rebinds and a crash before the first stamp
        with self._lock:
            cutting = [
                k for k, v in self._precopy.items()
                if v.get("stage") == "cutover"
            ]
        for pod_key in cutting:
            res = by_key.get(pod_key)
            if res is None:
                continue
            with self._lock:
                pc = self._precopy.get(pod_key)
            if pc is not None:
                self._stamp_cutover(pod_key, res, pc)

    # -- early drain completion (source role) ---------------------------------

    def _drain_early_pass(self, residents, acks: Dict[str, dict]) -> None:
        """While the node drains, reclaim every resident whose ack is
        durable and at or after the drain's cordon: the cards free the
        moment the checkpoint lands. Un-acked residents are untouched."""
        from .drain import DRAINING

        drain = self._drain
        if drain is None or drain.state != DRAINING:
            return
        started = drain.started_ts()
        trigger = drain.trigger
        by_key = dict(residents)
        for pod_key, ack in acks.items():
            if ack.get("kind") == "precopy":
                continue  # still streaming: only the final ack reclaims
            res = by_key.get(pod_key)
            if res is None:
                continue
            try:
                ts = float(ack.get("ts", 0.0))
            except (TypeError, ValueError):
                continue
            if started is not None and ts < started:
                continue  # a pre-drain ack saves nothing here
            with self._lock:
                prior = self._records.get(pod_key)
                if (
                    pod_key in self._migrated
                    and prior is not None and prior.get("reclaimed")
                ):
                    continue  # fully handled
            if prior is not None and pod_key in self._migrated:
                # a crash between the record's journal and the reclaim:
                # finish the (idempotent) teardown
                record = prior
            else:
                record = self._build_record(
                    pod_key, res, ack, f"drain:{trigger.split(':', 1)[0]}"
                )
                with self._lock:
                    self._records[pod_key] = record
                    self._migrated[pod_key] = record["uid"]
                    # the record absorbed the pre-copy stats
                    self._precopy.pop(pod_key, None)
                    self._early_reclaims_total += 1
                    self._journal_locked()  # before the reclaim
                faults.fire("migration.post_record")
                self._emit_recorded(record)
            report = self._reconciler.reclaim_pods([pod_key])
            with self._lock:
                rec = self._records.get(pod_key)
                if rec is not None:
                    rec["reclaimed"] = True
                    self._journal_locked()
            if self._metrics is not None:
                self._metrics.drain_early_reclaims.inc()
            self._emit(pod_key, record["trace"], action="early_reclaim",
                       step=record["step"], deadline_ts=drain.deadline_ts)
            logger.warning(
                "migration: %s acked step %s; bindings reclaimed %s "
                "early of the drain deadline (%s)",
                pod_key, record["step"],
                (f"{drain.deadline_ts - self._clock.time():.0f}s"
                 if drain.deadline_ts else "ahead"),
                report.get("reclaimed_pods"),
            )
        self._publish_pending()

    # -- destination role: restamp and verify ---------------------------------

    def _refresh_records_snapshot(self) -> bool:
        """One LIST of the Migrated objects -> {(ns, name): (object name,
        payload)}. False when the apiserver did not answer (the stale
        snapshot stands)."""
        from .crd import PhaseMigrated

        if self._crd is None:
            return False
        try:
            objs = self._crd.list_migrations()
        except Exception:  # noqa: BLE001 - apiserver blip
            return False
        snap: Dict[tuple, tuple] = {}
        for obj in objs:
            if obj.phase == PhaseMigrated and obj.migration:
                snap[(obj.claim_namespace, obj.claim_name)] = (
                    obj.name, dict(obj.migration))
        self._records_snapshot = snap
        self._records_snapshot_ts = self._clock.monotonic()
        return True

    def _inbound_pass(self, residents) -> None:
        """For every bound pod: adopt a published record (stamp the
        restore env), then verify the workload's resume ack."""
        now_mono = self._clock.monotonic()
        # the pods still to look up, each with how fresh a snapshot its
        # look needs: newer than its first sighting, and for the delayed
        # second look newer than the snapshot the first one read
        pending: List[Tuple[str, dict, float]] = []
        for pod_key, res in residents:
            with self._lock:
                if pod_key in self._inbound or pod_key in self._records:
                    continue
            first = self._first_seen.setdefault(pod_key, now_mono)
            attempts, next_ts, used_snap = self._resolve_attempts.get(
                pod_key, (0, first, None))
            if attempts >= 2 or now_mono < next_ts:
                continue
            pending.append((
                pod_key, res, first if used_snap is None else used_snap,
            ))
        if pending and (
            self._records_snapshot_ts is None
            or self._records_snapshot_ts
            <= max(need for _, _, need in pending)
        ):
            self._refresh_records_snapshot()
        for pod_key, res, need_after in pending:
            if (
                self._records_snapshot_ts is None
                or self._records_snapshot_ts <= need_after
            ):
                continue  # no fresh-enough snapshot yet
            attempts, _, _ = self._resolve_attempts.get(
                pod_key, (0, 0.0, None))
            self._resolve_attempts[pod_key] = (
                attempts + 1, now_mono + self.record_recheck_s,
                self._records_snapshot_ts,
            )
            entry = self._records_snapshot.get(
                (res["namespace"], res["name"]))
            if entry is None:
                continue  # no record; one delayed recheck, then final
            _, record = entry
            inbound = {
                "record": record,
                "stage": "restamped",
                "restamp_ts": self._clock.time(),
            }
            if not self._restamp_restore(pod_key, res, record):
                self._resolve_attempts.pop(pod_key, None)
                continue  # nothing journaled yet: next tick
            with self._lock:
                self._inbound[pod_key] = inbound
                self._journal_locked()
            self._emit(pod_key, record.get("trace") or "",
                       action="restore_stamped", step=record.get("step"),
                       source_node=record.get("source_node"),
                       mode=record.get("mode", "full"))
            logger.warning(
                "migration: %s has a published record (step %s from "
                "%s); restore env stamped", pod_key,
                record.get("step"), record.get("source_node"),
            )
        for pod_key, res in residents:
            with self._lock:
                inbound = self._inbound.get(pod_key)
            if inbound is not None and inbound.get("stage") == "restamped":
                # re-assert the stamp (a drift rebind may have rebuilt the
                # spec), then look for the resume ack
                self._restamp_restore(pod_key, res, inbound["record"])
                self._verify_resume(pod_key, res, inbound)

    def _restamp_restore(self, pod_key, res, record) -> bool:
        env = {
            EnvRestoreDir: str(record.get("checkpoint_dir", "")),
            EnvRestoreStep: str(record.get("step", "")),
        }
        if record.get("trace"):
            env[EnvRestoreTrace] = str(record["trace"])
        return self._restamp(pod_key, res, env, "restore")

    def _verify_resume(self, pod_key: str, res: dict, inbound: dict) -> None:
        record = inbound["record"]
        ack = self._read_ack(res["hashes"])
        if ack is None or ack.get("kind") != "resume":
            return
        problems = []
        acked_step = record.get("step")
        try:
            resumed_step = int(ack.get("step"))
        except (TypeError, ValueError):
            resumed_step = None
        if acked_step is not None and (
            resumed_step is None or resumed_step < int(acked_step)
        ):
            problems.append(
                f"resumed at step {resumed_step} < acked step {acked_step}"
            )
        expected_world = world_size_of(self._spec_env(res["hashes"]))
        got_world = ack.get("world_size")
        if got_world is not None and int(got_world) != expected_world:
            problems.append(
                f"resumed at world size {got_world}, current slice "
                f"world is {expected_world}"
            )
        if record.get("mode") == "precopy":
            # a pre-copy record's digest is the delta chain: before the
            # record may go, the destination proves it reassembled exactly
            # the blocks the source shipped (a torn final delta fails
            # here, and the record stays for the retry)
            want_chain = str(record.get("digest") or "")
            try:
                report = verify_delta_chain(
                    str(record.get("checkpoint_dir") or ""))
            except Exception as e:  # noqa: BLE001 - storage blip
                report = {"ok": False, "chain": "",
                          "problems": [f"chain verify unreadable: {e}"]}
            if not report.get("ok"):
                problems.append(
                    "delta chain verification failed: "
                    + "; ".join(report.get("problems") or ["unknown"])
                )
            elif want_chain and report.get("chain") != want_chain:
                problems.append(
                    f"delta chain {report.get('chain')} != recorded "
                    f"{want_chain}"
                )
        if problems:
            # one failing ack is one incident, however many ticks re-read
            # it
            failed_id = (ack.get("ts"), resumed_step, got_world)
            with self._lock:
                if inbound.get("last_failed") == list(failed_id):
                    return
                inbound["last_failed"] = list(failed_id)
                self._verify_failures_total += 1
                self._journal_locked()
            self._emit(pod_key, record.get("trace") or "",
                       action="verify_failed", problems=problems)
            logger.warning(
                "migration: %s resume verification FAILED: %s",
                pod_key, "; ".join(problems),
            )
            return
        now = self._clock.time()
        completion = {
            "pod": pod_key,
            "step": resumed_step,
            "world_size": expected_world,
            "source_node": record.get("source_node"),
            "trace": record.get("trace", ""),
            "mode": record.get("mode", "full"),
            "precopy": record.get("precopy"),
            "verified_ts": now,
            "downtime_s": (
                round(now - float(record["ack_ts"]), 3)
                if record.get("ack_ts") else None
            ),
        }
        with self._lock:
            self._inbound.pop(pod_key, None)
            self._completed_total += 1
            self._completed = (self._completed + [completion])[-32:]
            self._journal_locked()
        if self._metrics is not None:
            self._metrics.migrations_completed.inc()
        self._emit(pod_key, record.get("trace") or "", action="completed",
                   step=resumed_step, world_size=expected_world,
                   source_node=record.get("source_node"),
                   downtime_s=completion["downtime_s"],
                   mode=record.get("mode", "full"),
                   precopy=record.get("precopy"))
        if self._events is not None:
            from .kube.events import ReasonMigrationCompleted

            try:
                self._events.pod_event(
                    res["namespace"], res["name"],
                    ReasonMigrationCompleted,
                    f"resume verified at step {resumed_step}, world size "
                    f"{expected_world} (migrated from "
                    f"{record.get('source_node', '?')})",
                    trace_id=record.get("trace", ""),
                )
            except Exception:  # noqa: BLE001
                pass
        if self._crd is not None:
            # done: a record left behind would make the next pod of this
            # identity restore old state
            try:
                self._crd.delete(record.get("name") or migration_object_name(
                    res["namespace"], res["name"]))
            except Exception:  # noqa: BLE001
                logger.warning(
                    "migration: completed record delete for %s failed",
                    pod_key,
                )
        logger.warning(
            "migration: %s resume VERIFIED (step %s, world %s, "
            "downtime %ss)", pod_key, resumed_step, expected_world,
            completion["downtime_s"],
        )

    # -- sweeping -------------------------------------------------------------

    def _pod_gone(self, pod_key: str, armed_uid: str) -> bool:
        ns, _, name = pod_key.partition("/")
        pod = self._sitter.get_pod(ns, name)
        if pod is None:
            if self._client is not None:
                try:
                    pod = self._client.get_pod(ns, name)
                except Exception:  # noqa: BLE001 - unknowable: keep armed
                    return False
            if pod is None:
                return True
        uid = str(((pod or {}).get("metadata") or {}).get("uid", ""))
        return bool(armed_uid) and uid != armed_uid

    def _sweep(self, residents) -> None:
        """Suppression and records go once their pod generation is gone
        (a record only once it reached the apiserver: an unpublished
        record of a gone pod is the one a replacement will look for);
        retained acks of pods with nothing here stop aging in the
        gauge."""
        with self._lock:
            migrated = dict(self._migrated)
            # records without a suppression (publish_record arms none)
            # sweep by their own uid, or they would block a same-node
            # re-admission from adopting the record
            record_only = {
                k: r.get("uid", "") for k, r in self._records.items()
                if k not in migrated
            }
        dropped = False
        for pod_key, uid in migrated.items():
            if self._pod_gone(pod_key, uid):
                with self._lock:
                    self._migrated.pop(pod_key, None)
                    rec = self._records.get(pod_key)
                    if rec is not None and rec.get("published"):
                        self._records.pop(pod_key, None)
                    dropped = True
        for pod_key, uid in record_only.items():
            if self._pod_gone(pod_key, uid):
                with self._lock:
                    rec = self._records.get(pod_key)
                    if rec is not None and rec.get("published"):
                        self._records.pop(pod_key, None)
                        dropped = True
        resident_keys = {k for k, _ in residents}
        for k in [k for k in self._first_seen if k not in resident_keys]:
            self._first_seen.pop(k, None)
            self._resolve_attempts.pop(k, None)
        with self._lock:
            stale = [
                k for k in self._acked
                if k not in resident_keys and k not in self._migrated
                and k not in self._records
            ]
            for k in stale:
                # the ack's value stays (the drain's outcome may read it)
                self._last_acks.pop(k, None)
            for k in [k for k in self._inbound if k not in resident_keys]:
                self._inbound.pop(k, None)
                dropped = True
            for k in [k for k in self._precopy if k not in resident_keys]:
                self._precopy.pop(k, None)
                dropped = True
            if dropped:
                self._journal_locked()
        if self._metrics is not None:
            for k in stale:
                self._metrics.workload_checkpoint_age.remove(pod=k)

    # -- the tick -------------------------------------------------------------

    def tick(self) -> None:
        faults.fire("migration.pre_ack")
        residents = self._residents()
        if residents is None:
            return  # the store cannot answer: next tick
        acks = self._consume_acks(residents)
        self._precopy_pass(residents, acks)
        self._drain_early_pass(residents, acks)
        self._publish_pending()
        self._inbound_pass(residents)
        self._sweep(residents)

    def run(self, stop: threading.Event) -> None:
        """Supervised loop (DEGRADED): resume the journaled state, then
        tick at a jittered period, as the drain loop."""
        if not self._resumed:
            self.resume()
        consecutive_failures = 0
        sub = self._event_sub
        while True:
            delay = self.period_s * (0.75 + 0.5 * self._rng.random())
            if sub is not None and self._bus.healthy():
                with self._lock:
                    quiet = (not self._records and not self._acked
                             and not self._inbound and not self._precopy)
                if quiet:
                    delay *= self.event_safety_net_factor
            if sub is None:
                if stop.wait(delay):
                    return
            else:
                trig = sub.wait_trigger(stop, delay)
                if trig == "stop":
                    return
                if trig == "event":
                    # one tick for a burst (a drain's journal write and a
                    # bind commit)
                    if stop.wait(0.02):
                        return
                    sub.drain()
                    self.event_ticks_total += 1
            try:
                self.tick()
                consecutive_failures = 0
            except Exception as e:  # noqa: BLE001
                consecutive_failures += 1
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
                if consecutive_failures >= 3:
                    raise
                logger.exception(
                    "migration tick failed (%d consecutive; escalating "
                    "to the supervisor at 3)", consecutive_failures,
                )

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        """The ``migration`` block of /debug/allocations and the doctor
        bundle: ack freshness, outbound records, inbound verifications,
        pre-copy streams."""
        now = self._clock.time()
        with self._lock:
            return {
                "acked_pods": {
                    k: {
                        "ack_ts": ts,
                        "age_s": round(max(0.0, now - ts), 3),
                        "step": (self._last_acks.get(k) or {}).get("step"),
                        "kind": (self._last_acks.get(k) or {}).get(
                            "kind", "checkpoint"),
                    }
                    for k, ts in sorted(self._acked.items())
                },
                "records": {
                    k: {
                        f: r.get(f) for f in (
                            "step", "checkpoint_dir", "digest", "reason",
                            "published", "reclaimed", "trace",
                        )
                    }
                    for k, r in sorted(self._records.items())
                },
                "inbound": {
                    k: {
                        "stage": v.get("stage"),
                        "step": (v.get("record") or {}).get("step"),
                        "source_node": (v.get("record") or {}).get(
                            "source_node"),
                        "restamp_ts": v.get("restamp_ts"),
                    }
                    for k, v in sorted(self._inbound.items())
                },
                "precopy": {
                    k: {
                        "stage": v.get("stage"),
                        "rounds": len(v.get("rounds") or []),
                        "last_delta_bytes": (
                            (v.get("rounds") or [{}])[-1].get("delta_bytes")
                        ),
                        "cutover_ts": v.get("cutover_ts"),
                        "cutover_reason": v.get("cutover_reason"),
                    }
                    for k, v in sorted(self._precopy.items())
                },
                "suppressed_pods": sorted(self._migrated),
                "recent_completions": list(self._completed),
                "early_reclaims_total": self._early_reclaims_total,
                "records_published_total": self._records_published_total,
                "completed_total": self._completed_total,
                "precopy_rounds_total": self._precopy_rounds_total,
                "cutovers_total": self._cutovers_total,
                "verify_failures_total": self._verify_failures_total,
                "last_error": self._last_error,
            }
