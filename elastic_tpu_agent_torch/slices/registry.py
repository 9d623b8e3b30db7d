"""SliceRegistry: who is in which multi-host slice, and at what epoch.

Counterpart of ``elastic_tpu_agent/slices/registry.py``. The registry
assembles a slice's membership from pod annotations and the shared
apiserver's pods (never from agent-to-agent coordination), orders the
workers as a function of the host set so that every cooperating agent
derives the same identity env, checks worker-id/host consistency across
the cooperating pods, and stamps the slice env (with the slice's name and
its reform epoch) at PreStart. The reconciler's recovery path
(``slices/recovery.py``) reads and advances the same state.

Membership: a pod is a member of slice ``S`` when its
``elasticgpu.io/tpu-slice-id`` annotation is ``S``; its host is
``hosts[worker_id]`` under its own annotations. A member is live while its
pod exists and can run: a deleted, deleting, terminal or
``elasticgpu.io/draining`` pod is out, which is the signal a reform keys
off. One apiserver LIST serves every slice for a TTL, and one LIST at a
time is in flight, so that the bind path and the reconciler never turn
slice tracking into request amplification. A LIST that fails makes
membership unknown (``SliceMembershipError``), never empty.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common import (
    AnnotationSliceID,
    AnnotationSliceName,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
    EnvSliceEpoch,
    EnvSliceName,
)
from ..device.topology import (
    TopologyInfo,
    parse_accelerator_type,
    topology_for_hosts,
)
from ..slice_env import (
    ordered_worker_hostnames,
    slice_env_for_pod,
    slice_env_from_topology,
    split_hosts,
)

logger = logging.getLogger(__name__)

DEFAULT_MEMBERSHIP_TTL_S = 5.0


class SliceMembershipError(RuntimeError):
    """The shared apiserver could not answer a membership query; callers
    must treat membership as UNKNOWN (never as empty — an unreachable
    apiserver must not look like a slice whose members all died)."""


@dataclass
class SliceMember:
    """One cooperating pod's view of itself, read from its annotations."""

    pod_key: str
    node: str
    host: str
    worker_id: int
    hosts: Tuple[str, ...]


@dataclass
class _SliceState:
    """Node-local bookkeeping for one slice this node hosts members of."""

    slice_id: str
    accelerator_type: str = ""
    hosts: Tuple[str, ...] = ()
    epoch: int = 0
    reforms_total: int = 0
    local_pods: Dict[str, int] = field(default_factory=dict)  # pod_key -> wid
    last_validation: List[str] = field(default_factory=list)
    last_error: str = ""


def parse_hosts_annotation(annotations: Dict[str, str]) -> List[str]:
    """The membership claim's host list, via the shared
    :func:`slice_env.split_hosts` grammar: the apiserver-side
    membership parse, PreStart stamping and the stamped-spec parse
    must never disagree about the same list."""
    return split_hosts(annotations.get(AnnotationSliceWorkerHosts, ""))


def member_from_pod(pod: dict) -> Optional[SliceMember]:
    """Parse a pod manifest into its slice membership claim, or None
    when the pod does not claim one (or the claim is malformed)."""
    meta = pod.get("metadata", {}) or {}
    ann = meta.get("annotations", {}) or {}
    slice_id = ann.get(AnnotationSliceID, "")
    if not slice_id:
        return None
    hosts_raw = parse_hosts_annotation(ann)
    try:
        wid = int(ann.get(AnnotationSliceWorkerID, ""))
    except (TypeError, ValueError):
        wid = -1
    if not (0 <= wid < len(hosts_raw)):
        return None
    own_host = hosts_raw[wid]
    hosts, norm_wid = ordered_worker_hostnames(hosts_raw, own_host)
    return SliceMember(
        pod_key=f"{meta.get('namespace', '')}/{meta.get('name', '')}",
        node=pod.get("spec", {}).get("nodeName", ""),
        host=own_host,
        worker_id=norm_wid,
        hosts=tuple(hosts),
    )


class SliceRegistry:
    """Supervised-adjacent slice bookkeeping (no thread of its own: the
    bind path and the reconciler drive it; all entry points are
    thread-safe)."""

    def __init__(
        self,
        node_name: str = "",
        kube_client=None,
        metrics=None,
        events=None,
        membership_ttl_s: float = DEFAULT_MEMBERSHIP_TTL_S,
    ) -> None:
        self._node = node_name
        self._client = kube_client
        self._metrics = metrics
        self._events = events
        self._ttl = membership_ttl_s
        self._lock = threading.Lock()
        self._slices: Dict[str, _SliceState] = {}
        # One (monotonic ts, members-by-slice) snapshot per apiserver
        # list: a node hosting members of M slices serves all M from a
        # single LIST per TTL window instead of M full-cluster lists.
        # SliceMembershipError is never cached (an apiserver blip must
        # not poison a TTL window).
        self._members_snapshot: Optional[
            Tuple[float, Dict[str, List[SliceMember]]]
        ] = None
        # Single-flight: one refresh LIST at a time; TTL-expiry arrivals
        # either ride the stale snapshot or wait on the in-flight LIST
        # instead of stampeding the apiserver (same discipline as the
        # kubelet PodResourcesSnapshotSource).
        self._refresh_cond = threading.Condition(self._lock)
        self._refresh_inflight = False
        self._last_refresh_error = ""

    # -- membership from the shared apiserver ---------------------------------

    def live_members(
        self, slice_id: str, refresh: bool = False, stale_ok: bool = False
    ) -> List[SliceMember]:
        """Cooperating pods of ``slice_id`` that currently exist at the
        apiserver (TTL-cached). Raises SliceMembershipError when the
        apiserver cannot be asked and no fresh-enough cache exists.
        ``stale_ok`` serves ANY existing snapshot without refreshing —
        the bind path's mode, so PreStart never pays a full-cluster
        LIST once one has ever succeeded (the reconciler keeps the
        snapshot current off the bind path). A TTL of 0 means
        always-fresh and overrides ``stale_ok``."""
        now = time.monotonic()
        with self._lock:
            snap = self._members_snapshot
            if not refresh and snap and (
                (stale_ok and self._ttl > 0)
                or now - snap[0] < self._ttl
            ):
                return list(snap[1].get(slice_id, []))
            if self._refresh_inflight:
                if snap is not None and not refresh:
                    # Ride the stale snapshot rather than stampede: the
                    # in-flight LIST is already refreshing the window.
                    return list(snap[1].get(slice_id, []))
                # No data yet (or forced refresh): wait for the LIST in
                # flight instead of issuing a duplicate.
                while self._refresh_inflight:
                    self._refresh_cond.wait(timeout=30.0)
                snap = self._members_snapshot
                if snap is not None and (
                    not refresh or snap[0] >= now
                ):
                    return list(snap[1].get(slice_id, []))
                raise SliceMembershipError(
                    self._last_refresh_error
                    or "membership refresh failed in flight"
                )
            self._refresh_inflight = True
        # From here the in-flight flag is OURS: every exit (success,
        # apiserver failure, or any unexpected exception in parsing)
        # must clear it and wake waiters, or membership queries wedge
        # forever behind a flag nobody owns.
        try:
            if self._client is None:
                raise SliceMembershipError(
                    "no kube client: slice membership is unknowable"
                )
            counter = getattr(self._metrics, "apiserver_pod_lists", None)
            if counter is not None:
                counter.inc()
            try:
                pods = self._client.list_all_pods()
            except Exception as e:  # noqa: BLE001 - surface as UNKNOWN
                with self._lock:
                    # One failed LIST means membership is unknowable
                    # for EVERY slice, not just the one that asked.
                    for state in self._slices.values():
                        state.last_error = f"{type(e).__name__}: {e}"
                raise SliceMembershipError(str(e)) from e
            by_slice: Dict[str, List[SliceMember]] = {}
            for pod in pods:
                if not self._pod_is_live(pod):
                    continue
                member = member_from_pod(pod)
                if member is not None:
                    by_slice.setdefault(
                        self._slice_id_of_pod(pod), []
                    ).append(member)
            for members in by_slice.values():
                members.sort(key=lambda m: (m.worker_id, m.host, m.pod_key))
            with self._lock:
                self._members_snapshot = (time.monotonic(), by_slice)
                # Symmetric with the failure path: a successful LIST
                # answers for every slice, so no state keeps a stale
                # error while served from this healthy snapshot.
                for state in self._slices.values():
                    state.last_error = ""
                self._last_refresh_error = ""
            return list(by_slice.get(slice_id, []))
        except BaseException as e:
            with self._lock:
                self._last_refresh_error = f"{type(e).__name__}: {e}"
            raise
        finally:
            with self._lock:
                self._refresh_inflight = False
                self._refresh_cond.notify_all()

    @staticmethod
    def _pod_is_live(pod: dict) -> bool:
        """A member is live only while its pod can still run: deleting
        (deletionTimestamp) and terminal phases are OUT — a Failed pod
        that kube GC retains must not keep blocking reform while the
        fabric is already missing its worker. A pod its own agent marked
        ``elasticgpu.io/draining`` is out too: that is the PROACTIVE
        loss signal (drain.py) — the host is going away on a deadline,
        and counting it lost now lets the survivor world form BEFORE the
        loss instead of after a divergence pass."""
        from ..common import AnnotationDraining

        meta = pod.get("metadata", {}) or {}
        if meta.get("deletionTimestamp"):
            return False
        if (meta.get("annotations", {}) or {}).get(AnnotationDraining):
            return False
        phase = (pod.get("status", {}) or {}).get("phase", "")
        return phase not in ("Succeeded", "Failed")

    @staticmethod
    def _slice_id_of_pod(pod: dict) -> str:
        return (
            (pod.get("metadata", {}) or {}).get("annotations", {}) or {}
        ).get(AnnotationSliceID, "")

    def live_hosts(self, slice_id: str, refresh: bool = False) -> set:
        """Hostnames that still have a live member pod."""
        return {m.host for m in self.live_members(slice_id, refresh=refresh)}

    # -- consistency validation -----------------------------------------------

    def validate_members(
        self, slice_id: str, hosts: Tuple[str, ...]
    ) -> List[str]:
        """Cross-agent formation check: every cooperating pod must have
        derived the SAME normalized host ordering, and worker ids must be
        distinct per host. Returns human-readable problems (empty = the
        slice is consistently formed). Never raises — an unanswerable
        apiserver yields no verdict, not a failed bind. Runs on the
        BIND path, so it reads stale-tolerantly: any snapshot serves
        (only the very first slice bind on a node ever LISTs inline);
        the reconciler keeps the snapshot fresh from its own thread."""
        try:
            members = self.live_members(slice_id, stale_ok=True)
        except SliceMembershipError:
            return []
        problems: List[str] = []
        seen_ids: Dict[int, SliceMember] = {}
        for m in members:
            if m.hosts != hosts:
                problems.append(
                    f"{m.pod_key} derives hosts {list(m.hosts)} != "
                    f"{list(hosts)}"
                )
            prev = seen_ids.get(m.worker_id)
            if prev is None:
                seen_ids[m.worker_id] = m
            elif prev.host != m.host:
                problems.append(
                    f"worker id {m.worker_id} claimed by both "
                    f"{prev.host!r} and {m.host!r}"
                )
            elif prev.pod_key != m.pod_key:
                # Same slot, same host, two live pods: a duplicated
                # member (both would rendezvous as the same worker).
                problems.append(
                    f"worker id {m.worker_id} claimed by two live pods "
                    f"({prev.pod_key}, {m.pod_key}) on {m.host!r}"
                )
        return problems

    # -- PreStart stamping ----------------------------------------------------

    def pod_env(
        self,
        annotations: Dict[str, str],
        topo: Optional[TopologyInfo] = None,
        host_worker_id: int = 0,
        host_worker_hostnames: Optional[List[str]] = None,
    ) -> Dict[str, str]:
        """The slice env to stamp into a pod's alloc spec.

        Pods without a slice-id annotation keep the historical
        :func:`slice_env_for_pod` behavior verbatim (host-metadata-driven
        single-slice jobs, shape-only annotations). Slice-id pods get the
        registry treatment: deterministic worker ordering, a reform-aware
        world size (a slice the reconciler already re-formed stamps the
        REFORMED hosts, not the stale annotation set — a drift rebind
        must not silently undo a reform), the slice name, and the current
        epoch.
        """
        slice_id = annotations.get(AnnotationSliceID, "")
        if not slice_id:
            return slice_env_for_pod(
                annotations, topo, host_worker_id, host_worker_hostnames
            )
        ann_type = annotations.get(AnnotationSliceName, "")
        parsed = parse_accelerator_type(ann_type) if ann_type else None
        topo_for_pod = parsed if parsed is not None else topo
        hosts_raw = parse_hosts_annotation(annotations)
        try:
            ann_wid = int(annotations.get(AnnotationSliceWorkerID, ""))
        except (TypeError, ValueError):
            ann_wid = host_worker_id
        own_host = ""
        if 0 <= ann_wid < len(hosts_raw):
            own_host = hosts_raw[ann_wid]
        elif host_worker_hostnames and 0 <= host_worker_id < len(
            host_worker_hostnames
        ):
            own_host = host_worker_hostnames[host_worker_id]
        hosts, wid = ordered_worker_hostnames(hosts_raw, own_host)
        if topo_for_pod is None or wid < 0 or not hosts:
            # Unusable claim: stamp what slice_env_for_pod would have and
            # let validation/events surface the malformation.
            logger.warning(
                "slice %s: unusable membership claim (hosts=%s wid=%d); "
                "falling back to annotation-order env", slice_id,
                hosts_raw, ann_wid,
            )
            env = slice_env_for_pod(
                annotations, topo, host_worker_id, host_worker_hostnames
            )
            if env:
                env[EnvSliceName] = slice_id
                env.setdefault(EnvSliceEpoch, "0")
            return env
        reformed = False
        with self._lock:
            state = self._slices.setdefault(slice_id, _SliceState(slice_id))
            state.accelerator_type = (
                ann_type or getattr(topo_for_pod, "accelerator_type", "")
            )
            if state.epoch > 0 and own_host in state.hosts:
                # Reform override: the reconciler owns the current world.
                hosts = list(state.hosts)
                wid = hosts.index(own_host)
                reformed = True
            else:
                state.hosts = tuple(hosts)
            epoch = state.epoch
        topo_eff = topology_for_hosts(topo_for_pod, len(hosts))
        env = slice_env_from_topology(topo_eff, wid, hosts)
        env[EnvSliceName] = slice_id
        env[EnvSliceEpoch] = str(epoch)
        # Formation-time consistency check only: after a reform the
        # cooperating pods' ANNOTATIONS still describe the original
        # world, so re-validating them against the reformed host set
        # would flag every healthy member as inconsistent.
        problems = (
            [] if reformed
            else self.validate_members(slice_id, tuple(hosts))
        )
        with self._lock:
            state = self._slices.get(slice_id)
            if state is None:
                # A reconciler prune raced this first bind: the pod's
                # record isn't in the store yet, so the slice looked
                # inactive while we validated outside the lock. Epoch is
                # still 0 at formation time, so re-creating the state is
                # equivalent to never having lost it.
                state = _SliceState(slice_id)
                state.accelerator_type = (
                    ann_type
                    or getattr(topo_for_pod, "accelerator_type", "")
                )
                if not reformed:
                    state.hosts = tuple(hosts)
                self._slices[slice_id] = state
            state.last_validation = problems
        if problems:
            logger.warning(
                "slice %s formed INCONSISTENTLY: %s", slice_id,
                "; ".join(problems),
            )
            if self._events is not None:
                from ..kube.events import ReasonSliceInconsistent

                self._events.node_event(
                    ReasonSliceInconsistent,
                    f"slice {slice_id}: " + "; ".join(problems[:3]),
                    type_="Warning",
                )
        self._update_members_gauge(slice_id, len(hosts))
        return env

    def record_local_pod(self, slice_id: str, pod_key: str, wid: int) -> None:
        """Remember that ``pod_key`` (bound on THIS node) is a member —
        the /debug and doctor surfaces list local members per slice."""
        with self._lock:
            state = self._slices.setdefault(slice_id, _SliceState(slice_id))
            state.local_pods[pod_key] = wid

    def drop_local_pod(self, slice_id: str, pod_key: str) -> None:
        """Forget one local member whose store record is gone (reconciler
        housekeeping): the slice survives while other local members
        remain, but a reclaimed pod must not be listed as a live member
        on /debug or in the doctor bundle forever."""
        with self._lock:
            state = self._slices.get(slice_id)
            if state is not None:
                state.local_pods.pop(pod_key, None)

    # -- reform bookkeeping (driven by slices/recovery.py) --------------------

    def observe_stamped(
        self,
        slice_id: str,
        hosts: Tuple[str, ...],
        epoch: int,
        accelerator_type: str = "",
    ) -> None:
        """Re-learn durable slice state from a stamped alloc spec.

        The on-disk env survives agent restarts; this in-memory registry
        does not. Every reconcile pass feeds the stamped (hosts, epoch)
        back in, raising the registry's view to at least the stamped
        epoch — so a restart (or an over-eager prune) can never make a
        later reform repeat or regress an epoch the runner already saw,
        and pod_env's reform override stays armed for drift rebinds.
        Never lowers state: a spec not yet restamped by an in-flight
        reform must not drag the registry backwards.
        """
        hosts = tuple(hosts)
        with self._lock:
            state = self._slices.setdefault(slice_id, _SliceState(slice_id))
            if accelerator_type and not state.accelerator_type:
                state.accelerator_type = accelerator_type
            if epoch > state.epoch:
                state.epoch = epoch
                state.hosts = hosts
            elif not state.hosts:
                state.hosts = hosts
            world = len(state.hosts)
        self._update_members_gauge(slice_id, world)

    def current_hosts(self, slice_id: str) -> Tuple[str, ...]:
        with self._lock:
            state = self._slices.get(slice_id)
            return state.hosts if state is not None else ()

    def epoch(self, slice_id: str) -> int:
        with self._lock:
            state = self._slices.get(slice_id)
            return state.epoch if state is not None else 0

    def note_reform(
        self, slice_id: str, new_hosts: Tuple[str, ...]
    ) -> int:
        """Advance the slice to ``new_hosts``; returns the epoch to stamp.

        Idempotent per world: a second member pod of the same slice on
        this node re-forming to the SAME host set reuses the epoch
        instead of bumping it twice (both pods must restart into the
        same generation)."""
        with self._lock:
            state = self._slices.setdefault(slice_id, _SliceState(slice_id))
            if state.hosts == tuple(new_hosts) and state.epoch > 0:
                return state.epoch
            state.hosts = tuple(new_hosts)
            state.epoch += 1
            state.reforms_total += 1
            epoch = state.epoch
        if self._metrics is not None and hasattr(
            self._metrics, "slice_reforms"
        ):
            try:
                self._metrics.slice_reforms.labels(slice=slice_id).inc()
            except Exception:  # noqa: BLE001 - metrics never break reform
                pass
        self._update_members_gauge(slice_id, len(new_hosts))
        return epoch

    def _update_members_gauge(self, slice_id: str, world: int) -> None:
        if self._metrics is not None and hasattr(
            self._metrics, "slice_members"
        ):
            try:
                # BoundedLabeledGauge: cardinality-guarded per-slice series
                self._metrics.slice_members.set(world, slice=slice_id)
            except Exception:  # noqa: BLE001
                pass

    # -- housekeeping ---------------------------------------------------------

    def prune(self, active_slice_ids: set) -> None:
        """Forget slices with no member pod bound on this node any more
        (reconciler calls this with the slice ids it saw in the store);
        their member gauges are removed so a dashboard never shows a
        ghost slice."""
        with self._lock:
            gone = [s for s in self._slices if s not in active_slice_ids]
            for slice_id in gone:
                del self._slices[slice_id]
                if self._members_snapshot is not None:
                    self._members_snapshot[1].pop(slice_id, None)
        for slice_id in gone:
            # Both per-slice series go with the slice: ids are job-unique,
            # so leaving them behind would grow the scrape without bound
            # under job churn (members is additionally cardinality-guarded
            # by BoundedLabeledGauge for the dry-run mode where prune
            # never runs).
            members = getattr(self._metrics, "slice_members", None)
            if members is not None:
                try:
                    members.remove(slice=slice_id)
                except Exception:  # noqa: BLE001 - series may not exist
                    pass
            reforms = getattr(self._metrics, "slice_reforms", None)
            if reforms is not None:
                try:
                    reforms.remove(slice_id)
                except Exception:  # noqa: BLE001 - series may not exist
                    pass

    # -- introspection --------------------------------------------------------

    def status(self) -> dict:
        """The ``slices`` block of /debug/allocations and the doctor
        bundle: per-slice world, epoch, local members, reform count and
        the last formation-validation verdict."""
        with self._lock:
            return {
                slice_id: {
                    "accelerator_type": state.accelerator_type,
                    "hosts": list(state.hosts),
                    "world_size": len(state.hosts),
                    "epoch": state.epoch,
                    "reforms_total": state.reforms_total,
                    "local_pods": dict(state.local_pods),
                    "validation_problems": list(state.last_validation),
                    "last_error": state.last_error,
                }
                for slice_id, state in self._slices.items()
            }
