"""Device->pod locator: which pod/container owns this fake-device set?

The port's copy of ``elastic_tpu_agent/kube/locator.py``. The
pod-resources client it reads (``rpc.PodResourcesClient``) is handed in,
never imported here: this module, and the plugins that raise its
``LocateError``, import without grpc. With ``metrics`` every List is
counted (``elastic_tpu_kubelet_list_total``); with a ``bus`` the diff of
each installed List publishes assignment deltas (events.py).

Capability parity with the reference's ``pkg/kube/locator.go`` (SURVEY.md §1
L5): PreStartContainer only receives device IDs, so the agent asks the
kubelet pod-resources API for the full node dump and matches the sorted
ID set. Both response shapes are handled: k8s ≤1.20 returned all IDs of a
resource in one ContainerDevices entry, ≥1.21 one entry per ID
(locator.go:69-89) — we simply merge every entry of the target resource per
container before comparing.

Perf (this is the Allocate/PreStart p50 hot path, BASELINE.md): the
reference sent a full-node List per Locate call, O(pods x containers x
devices) each time. Two layers fix that:

- ``PodResourcesSnapshotSource`` — ONE kubelet ``List`` builds a
  hash-indexed snapshot for EVERY extended resource in the response, with
  single-flight refresh (concurrent misses join one in-flight List instead
  of stampeding the kubelet) and a debounced background prefetch. The
  manager shares one source across the core and memory locators, so a
  cold core+memory bind pair costs one List, not two.
- ``KubeletDeviceLocator`` — a thin per-resource view over a source:
  steady-state repeat locates are O(1) dict hits; a miss joins or pays a
  refresh and retries once.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Dict, Optional

from .. import events as events_mod
from ..tracing import get_tracer
from ..types import Device, PodContainer, device_hash

logger = logging.getLogger(__name__)

# The snapshot is replaced wholesale on every List, so its size tracks live
# node pods (kubelet caps out at a few hundred). The cap is a backstop
# against a pathological pod-resources response (e.g. a buggy kubelet
# echoing stale pods into the 16MiB List): evicted entries just fall back
# to an inline refresh at locate() time. Applied PER RESOURCE.
_MAX_CACHE_ENTRIES = 4096


class LocateError(Exception):
    pass


class PodResourcesSnapshotSource:
    """Shared, single-flight pod-resources snapshot layer.

    One kubelet ``List`` yields ``{resource: {device-set hash: owner}}``
    for every resource in the response; any number of per-resource
    locators consume it. Refreshes are single-flight: a caller that
    misses while a List is in flight (usually the Allocate-time prefetch,
    or a sibling resource's cold locate) joins it instead of paying a
    duplicate full-node dump.
    """

    # How long a cache miss will wait for an in-flight refresh (usually
    # the Allocate-time prefetch) before paying its own List. A full-node
    # List is single-digit ms even at 1000 pods, so this bound only bites
    # when the kubelet itself is stalling.
    JOIN_REFRESH_TIMEOUT_S = 0.25
    # How long refresh() queues behind another caller's in-flight List
    # before abandoning single-flight and issuing its own concurrently.
    # Just over the client's per-List deadline: a healthy kubelet never
    # trips it, while a STALLED one degrades to the concurrent-failure
    # shape (every miss errors out in ~one List deadline) instead of
    # serializing misses one stalled List at a time.
    STALL_WAIT_TIMEOUT_S = 6.0

    def __init__(self, client, metrics=None, bus=None) -> None:
        self._client = client
        # Optional AgentMetrics: every List sent is counted in
        # elastic_tpu_kubelet_list_total, at the source.
        self._metrics = metrics
        # Optional events.EventBus: every installed List is diffed
        # against the previous one and the per-hash deltas published on
        # ASSIGNMENT_DELTA, so that the reconciler reacts to kubelet-side
        # assignment changes instead of finding them on its next sweep.
        self._bus = bus
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # resource -> device-set hash -> owner
        self._snapshot: Dict[str, Dict[str, PodContainer]] = {}
        self._refresh_seq = 0       # ordering guard: a slow, stale List
        self._installed_seq = 0     # must never replace a newer snapshot
        self._done_seq = 0          # highest seq whose List has completed
        # In-flight List count. Single-flight keeps it at <=1 on a
        # healthy kubelet; the stall-timeout escape lets it exceed 1 so
        # a wedged List cannot serialize every miss behind it.
        self._refresh_active = 0
        self._refreshing = 0        # in-flight List count (join target)
        self._last_full: Dict[str, Dict[str, PodContainer]] = {}
        # resource -> hash -> (owner, device-id tuple): the same List,
        # with the raw ids retained. The reconciler needs them — a bind
        # replay must reconstruct the exact Device from kubelet's
        # assignment, not just learn who owns a hash.
        self._last_assign: Dict[str, Dict[str, tuple]] = {}
        self._prefetch_wake = threading.Event()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_debounce_s = 0.0005
        self.lists_total = 0        # kubelet Lists actually sent

    def join_or_lookup(
        self, resource: str, key: str
    ) -> Optional[PodContainer]:
        """Fast-path lookup that, on a miss with a List in flight (or a
        prefetch about to start), waits for that List to land and looks
        again — the common PreStart-raced-the-prefetch case."""
        with self._cond:
            hit = self._snapshot.get(resource, {}).get(key)
            if hit is None and (
                self._refreshing > 0 or self._prefetch_wake.is_set()
            ):
                seen = self._installed_seq
                self._cond.wait_for(
                    lambda: (
                        self._installed_seq > seen
                        or (
                            self._refreshing == 0
                            and not self._prefetch_wake.is_set()
                        )
                    ),
                    timeout=self.JOIN_REFRESH_TIMEOUT_S,
                )
                hit = self._snapshot.get(resource, {}).get(key)
            return hit

    @staticmethod
    def _build_index(resp) -> tuple:
        """One pass over the List: (hash->owner index, hash->(owner, ids)
        assignment map), both keyed per resource. The owner index is
        DERIVED from the assignment map so the two views can never
        drift."""
        assign: Dict[str, Dict[str, tuple]] = {}
        for pod in resp.pod_resources:
            for container in pod.containers:
                ids_by_resource: Dict[str, list] = {}
                for dev in container.devices:
                    # merges both the ≤1.20 one-entry-many-ids and
                    # the ≥1.21 one-id-per-entry shapes
                    ids_by_resource.setdefault(
                        dev.resource_name, []
                    ).extend(dev.device_ids)
                for resource, ids in ids_by_resource.items():
                    if ids:
                        assign.setdefault(resource, {})[
                            device_hash(ids)
                        ] = (
                            PodContainer(
                                pod.namespace, pod.name, container.name
                            ),
                            tuple(sorted(ids)),
                        )
        fresh = {
            resource: {h: owner_ids[0] for h, owner_ids in entries.items()}
            for resource, entries in assign.items()
        }
        return fresh, assign

    @staticmethod
    def _capped(
        fresh: Dict[str, Dict[str, PodContainer]]
    ) -> Dict[str, Dict[str, PodContainer]]:
        capped = {
            res: len(index) for res, index in fresh.items()
            if len(index) > _MAX_CACHE_ENTRIES
        }
        if not capped:
            return fresh
        logger.warning(
            "pod-resources List yielded %s device sets; capping "
            "each resource's cache at %d", capped, _MAX_CACHE_ENTRIES,
        )
        # cap only the shared snapshot; refresh() callers still consult
        # the full return value, so evicted sets resolve on their inline
        # refresh
        return {
            res: (
                dict(itertools.islice(index.items(), _MAX_CACHE_ENTRIES))
                if res in capped else index
            )
            for res, index in fresh.items()
        }

    def refresh(
        self, fresh_start: bool = True
    ) -> Dict[str, Dict[str, PodContainer]]:
        """Full List -> rebuild the hash index for every resource;
        returns the fresh (uncapped) snapshot.

        SINGLE-FLIGHT: at most one List is in flight per source, ever.
        With ``fresh_start=True`` (a locate miss) the caller is
        guaranteed a snapshot from a List that STARTED after this call —
        so an assignment kubelet recorded before the miss is visible —
        but concurrent missers coalesce onto ONE such List instead of
        stampeding the kubelet (a restore storm used to send one List
        per in-flight PreStart). ``fresh_start=False`` (the prefetch) is
        best-effort: any List completing after the call suffices, so a
        prefetch that finds a refresh already in flight just rides it.

        Installs into the shared snapshot only if no later-started
        refresh already installed its result (a slow stale List must
        never clobber a newer one)."""
        with self._cond:
            # The requirement is fixed at entry: fresh_start needs any
            # run with seq > the one in flight (or last started) NOW —
            # i.e. a run that starts after this call; best-effort needs
            # any run COMPLETING after this call.
            need = (
                self._refresh_seq + 1 if fresh_start
                else self._done_seq + 1
            )
            deadline = time.monotonic() + self.STALL_WAIT_TIMEOUT_S
            while self._done_seq < need and self._refresh_active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # The in-flight List is stalling (kubelet wedged):
                    # stop queueing behind it and pay our own List in
                    # parallel, so misses fail/succeed in ~one List
                    # deadline instead of one stalled List EACH.
                    break
                self._cond.wait(timeout=remaining)
            if self._done_seq >= need:
                return self._last_full
            self._refresh_active += 1
            self._refreshing += 1
            self._refresh_seq += 1
            seq = self._refresh_seq
        try:
            with get_tracer().span("pod_resources_list") as sp:
                resp = self._client.list()
                self.lists_total += 1
                m = self._metrics
                if m is not None and hasattr(m, "kubelet_lists"):
                    try:
                        m.kubelet_lists.inc()
                    except Exception:  # noqa: BLE001 - never fail a List
                        pass
                sp.set(pods=len(resp.pod_resources))
            fresh, assign = self._build_index(resp)
            install = self._capped(fresh)
            deltas = None
            with self._cond:
                if seq > self._installed_seq:
                    if self._bus is not None and self._installed_seq > 0:
                        deltas = self._assignment_deltas(
                            self._last_assign, assign
                        )
                    self._installed_seq = seq
                    self._snapshot = install
                    self._last_full = fresh
                    self._last_assign = assign
                self._done_seq = max(self._done_seq, seq)
            if deltas:
                # Published OUTSIDE the cond: publish fans out to
                # subscriber queues (their own locks) and must never
                # extend the snapshot critical section.
                for kind, resource, hsh, owner in deltas:
                    self._bus.publish(
                        events_mod.ASSIGNMENT_DELTA, kind=kind, key=hsh,
                        payload={"resource": resource, "owner": owner},
                    )
            return fresh
        finally:
            # ANY exit — including a parse failure after a successful
            # List — must release the single-flight slot, or every
            # future miss would queue behind a corpse.
            with self._cond:
                self._refresh_active -= 1
                self._refreshing -= 1
                self._cond.notify_all()

    @staticmethod
    def _assignment_deltas(old: Dict[str, Dict[str, tuple]],
                           new: Dict[str, Dict[str, tuple]]) -> list:
        """Per-hash diff between two kubelet assignment snapshots:
        ``(kind, resource, hash, "ns/pod/container")`` tuples with kind
        in added/removed/owner-changed. O(assignments); bounded by node
        pod count."""
        deltas = []
        for resource in set(old) | set(new):
            before = old.get(resource, {})
            after = new.get(resource, {})
            for hsh in set(before) | set(after):
                b, a = before.get(hsh), after.get(hsh)
                if b is None and a is not None:
                    kind, owner = "added", a[0]
                elif b is not None and a is None:
                    kind, owner = "removed", b[0]
                elif b is not None and a is not None and b[0] != a[0]:
                    kind, owner = "owner-changed", a[0]
                else:
                    continue
                deltas.append((
                    kind, resource, hsh,
                    f"{owner.pod_key}/{owner.container}",
                ))
        return deltas

    def invalidate(self) -> None:
        with self._lock:
            self._snapshot = {}

    def stats(self) -> Dict[str, object]:
        """Snapshot introspection for the debug/diagnostics surfaces."""
        with self._lock:
            return {
                "resources": {
                    res: len(index)
                    for res, index in self._snapshot.items()
                },
                "installed_seq": self._installed_seq,
                "refresh_seq": self._refresh_seq,
                "refreshing": self._refreshing,
                "prefetch_pending": self._prefetch_wake.is_set(),
                "lists_total": self.lists_total,
            }

    def assignments(
        self, fresh_start: bool = True
    ) -> Dict[str, Dict[str, tuple]]:
        """Fresh kubelet view with device ids retained:
        ``{resource: {hash: (owner, ids)}}`` — the reconciler's side of
        the store<->kubelet diff. ``fresh_start`` has refresh()'s
        semantics (True = a List that started after this call)."""
        self.refresh(fresh_start=fresh_start)
        with self._lock:
            return {
                res: dict(entries)
                for res, entries in self._last_assign.items()
            }

    def prefetch_async(self) -> None:
        """Refresh the snapshot in the background.

        Called at Allocate time: kubelet records the assignment right after
        the Allocate RPC returns and then spends sandbox-setup time before
        PreStartContainer, so the full pod-resources List overlaps work we
        are not on the critical path for — PreStart's locate() then hits
        the warm snapshot instead of paying the O(node pods) List inline
        (the reference paid it on every PreStart, locator.go:43-93). With
        the source shared across resources, the core plugin's prefetch
        warms the memory plugin's PreStart too (and vice versa).

        A single persistent worker debounces bursts: the wake flag
        coalesces any number of prefetch requests into one List, and the
        small debounce delay lets kubelet's assignment record land before
        the snapshot is taken. A miss at PreStart still falls back to a
        fresh inline List, so this is purely an overlap optimization.
        """
        with self._lock:
            if self._prefetch_thread is None:
                self._prefetch_thread = threading.Thread(
                    target=self._prefetch_loop,
                    daemon=True,
                    name="pod-resources-prefetch",
                )
                self._prefetch_thread.start()
        self._prefetch_wake.set()

    def _prefetch_loop(self) -> None:
        while True:
            self._prefetch_wake.wait()
            time.sleep(self._prefetch_debounce_s)
            # Clear-then-refresh under the cond: a locate() miss joining a
            # "pending" prefetch keys off wake-or-refreshing; without the
            # lock there is a visible instant where both are false and the
            # join falls through to a duplicate List.
            with self._cond:
                self._prefetch_wake.clear()
                self._refreshing += 1
            try:
                # Best-effort freshness: a refresh already in flight (a
                # concurrent miss, or the sibling resource's prefetch) is
                # ridden, not duplicated — under a bind storm the
                # prefetch stream collapses into the misses' Lists.
                self.refresh(fresh_start=False)
            except Exception:  # noqa: BLE001 - locate() retries inline
                pass
            finally:
                with self._cond:
                    self._refreshing -= 1
                    self._cond.notify_all()


class KubeletDeviceLocator:
    """Per-resource locate() view over a PodResourcesSnapshotSource.

    One locator per extended resource (reference: base.go:56-58). Pass
    ``source`` to share one snapshot layer across resources (the manager
    does — that is what halves cold-locate Lists); constructing with a
    bare ``client`` keeps the old one-source-per-locator shape for tests
    and tools.
    """

    def __init__(
        self,
        resource: str,
        client=None,
        source: Optional[PodResourcesSnapshotSource] = None,
    ) -> None:
        if source is None:
            if client is None:
                raise ValueError("need a client or a shared source")
            source = PodResourcesSnapshotSource(client)
        self._resource = resource
        self._source = source

    @property
    def source(self) -> PodResourcesSnapshotSource:
        return self._source

    def locate(self, device: Device) -> PodContainer:
        with get_tracer().span(
            "locator_locate", resource=self._resource, hash=device.hash
        ) as sp:
            owner = self._locate(device, sp)
            sp.set(pod=owner.pod_key, container=owner.container)
            return owner

    def _locate(self, device: Device, sp) -> PodContainer:
        key = device.hash
        hit = self._source.join_or_lookup(self._resource, key)
        if hit is not None:
            sp.set(cache_hit=True)
            return hit
        sp.set(cache_hit=False)
        # Miss: refresh inline, consulting OUR OWN snapshot (the shared
        # one may be concurrently replaced by a prefetch). One retry
        # absorbs transient channel resets from concurrent users.
        last_error: Optional[Exception] = None
        for _ in range(2):
            try:
                fresh = self._source.refresh()
            except Exception as e:  # noqa: BLE001 - client re-dials next call
                last_error = e
                continue
            hit = fresh.get(self._resource, {}).get(key)
            if hit is not None:
                return hit
            last_error = None
            break
        if last_error is not None:
            raise LocateError(
                f"pod-resources List failed: {last_error}"
            ) from last_error
        raise LocateError(
            f"no pod owns device set {key} for {self._resource}"
        )

    def invalidate(self) -> None:
        self._source.invalidate()

    def stats(self) -> Dict[str, object]:
        """Cache introspection for the debug/diagnostics surfaces
        (/debug/allocations, node-doctor): is the hash index warm, how
        many device sets it holds, and whether a refresh is in flight."""
        src = self._source.stats()
        return {
            "resource": self._resource,
            "cache_entries": src["resources"].get(self._resource, 0),
            "installed_seq": src["installed_seq"],
            "refresh_seq": src["refresh_seq"],
            "refreshing": src["refreshing"],
            "prefetch_pending": src["prefetch_pending"],
            "lists_total": src["lists_total"],
            "shared_source": True,
        }

    def prefetch_async(self) -> None:
        self._source.prefetch_async()
