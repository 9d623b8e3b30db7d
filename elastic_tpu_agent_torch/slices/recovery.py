"""Elastic slice recovery: detect member loss, re-form the survivors.

Counterpart of ``elastic_tpu_agent/slices/recovery.py``. Without it a
slice member that goes leaves the survivors hung at the next collective:
their env says world 2, the network holds 1. The reconciler treats slice
membership as a divergence class, and this module is its repair:

- **detect** (:meth:`SliceReformer.divergence`): the hosts stamped into a
  bound pod's alloc-spec env are the slice the workload believes in; the
  registry's apiserver-derived live membership is the slice that exists.
  A stamped host with no live member pod is a lost member, a live host
  that is not stamped a joined one.
- **repair** (:meth:`SliceReformer.reform`): under the owner's bind stripe
  (the lock live binds take, so that a reform never interleaves a
  rebind's spec write), restamp every spec of the container with the
  slice env at the surviving world size, a re-derived worker id and a
  bumped ``ELASTIC_TPU_SLICE_EPOCH``; journal ``slice_reformed`` and post a
  ``TPUSliceReformed`` pod Event. A running runner's lifecycle watcher
  reads the spec, sees the epoch rise, checkpoints and acks; the restart
  restores at the new world size.

Growth is the same diff: a replacement member appearing re-forms the
slice back up, its epoch bumped again.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..common import EnvSliceEpoch, EnvSliceName
from ..device.topology import parse_accelerator_type, topology_for_hosts
from ..slice_env import (
    ordered_worker_hostnames,
    slice_env_from_topology,
    split_hosts,
)
from .registry import SliceMembershipError, SliceRegistry

logger = logging.getLogger(__name__)


class SliceReformer:
    """Reconciler-side executor for slice-membership divergences."""

    def __init__(
        self,
        registry: SliceRegistry,
        plugin,
        metrics=None,
        events=None,
        timeline=None,
    ) -> None:
        self._registry = registry
        self._plugin = plugin
        self._metrics = metrics
        self._events = events
        self._timeline = timeline

    @property
    def registry(self) -> SliceRegistry:
        return self._registry

    def _spec_plugin(self):
        """Any per-resource plugin (they share the alloc-spec dir)."""
        return getattr(self._plugin, "core", None)

    # -- detect ---------------------------------------------------------------

    def stamped_view(
        self, records: Dict[str, object]
    ) -> Optional[Tuple[str, List[str], int, int, dict, bool]]:
        """(slice_id, stamped_hosts, stamped_worker_id, stamped_epoch,
        spec, torn) from the container's on-disk alloc specs, or None
        when no spec carries a slice stamp (not a slice pod, or the spec
        is gone — the artifact walk repairs that separately).

        ALL sibling specs are read (a core+memory container has one per
        resource): the highest-epoch stamp wins, and ``torn`` reports a
        sibling disagreeing about world or epoch — a crash between
        ``restamp_spec_env_locked``'s per-file writes, which must be a
        repairable divergence, not dict-iteration-order luck."""
        plugin = self._spec_plugin()
        if plugin is None:
            return None
        views = []
        for record in records.values():
            spec = plugin.read_alloc_spec(record.device.hash)
            if spec is None:
                continue
            env = spec.get("env", {}) or {}
            slice_id = env.get(EnvSliceName, "")
            hosts = split_hosts(env.get("TPU_WORKER_HOSTNAMES", ""))
            if not slice_id or not hosts:
                continue
            try:
                wid = int(env.get("TPU_WORKER_ID", ""))
            except ValueError:
                wid = -1
            try:
                epoch = int(env.get(EnvSliceEpoch, "0"))
            except ValueError:
                epoch = 0
            views.append((slice_id, hosts, wid, epoch, spec))
        if not views:
            return None
        best = max(views, key=lambda v: v[3])
        torn = any(
            v[0] != best[0] or v[1] != best[1] or v[3] != best[3]
            for v in views
        )
        return best + (torn,)

    def observe(self, stamped: Tuple) -> None:
        """Feed a stamped view back into the registry (see
        :meth:`SliceRegistry.observe_stamped`): the spec is the durable
        record of the current world + epoch; the registry re-learns it
        every reconcile pass so an agent restart never forgets a reform."""
        slice_id, hosts, _wid, epoch, spec = stamped[:5]
        self._registry.observe_stamped(
            slice_id, tuple(hosts), epoch,
            accelerator_type=spec.get("env", {}).get(
                "TPU_ACCELERATOR_TYPE", ""
            ),
        )

    def divergence(
        self,
        owner,
        records: Dict[str, object],
        live_hosts_cache: Optional[Dict[str, set]] = None,
        stamped: Optional[tuple] = None,
    ) -> Optional[dict]:
        """Compare the container's stamped slice against live membership;
        returns the reform work order, or None when consistent (or not a
        slice pod). Raises SliceMembershipError when membership is
        unknowable — the caller must skip, not treat it as loss.
        ``stamped`` lets the caller pass a pre-read (and pre-observed)
        :meth:`stamped_view` instead of re-reading the specs."""
        if stamped is None:
            stamped = self.stamped_view(records)
            if stamped is None:
                return None
            # Registry re-learn before any verdict: the stamped epoch is
            # the durable floor a reform must bump past, restart or not.
            self.observe(stamped)
        slice_id, hosts, wid, stamped_epoch, spec, torn = stamped
        if not (0 <= wid < len(hosts)):
            return None  # malformed stamp: validation's problem, not ours
        own_host = hosts[wid]
        if live_hosts_cache is not None and slice_id in live_hosts_cache:
            live = live_hosts_cache[slice_id]
        else:
            live = self._registry.live_hosts(slice_id)
            if live_hosts_cache is not None:
                live_hosts_cache[slice_id] = live
        if own_host not in live:
            # Our own member pod is invisible at the apiserver while the
            # sitter still sees it live — a watch/list race. Reforming
            # ourselves out of our own slice can never be right; wait.
            return None
        canonical, _ = ordered_worker_hostnames(hosts)
        if live == set(hosts) and hosts == canonical and not torn:
            return None
        # The reformed ordering is the SAME pure function of the host
        # set that formation uses (ordered_worker_hostnames): a joining
        # replacement's fresh agent derives its world from its own
        # annotations, so survivors appending joiners at the tail would
        # permanently disagree with the joiner about who is worker 0 —
        # both orderings must collapse to one function of the set,
        # coordination-free. Survivors still keep their RELATIVE order
        # (formation order is already canonical; removing/inserting
        # sorted elements preserves it), and the epoch bump makes any id
        # shift a checkpoint-restore, not a silent renumber. The same
        # work order heals a torn restamp (sibling specs at different
        # worlds/epochs after a mid-reform crash) and a non-canonical
        # stamp: for an unchanged world note_reform reuses the epoch and
        # the repair just re-stamps every sibling into ONE generation.
        new_hosts, new_wid = ordered_worker_hostnames(
            list(live), own_host
        )
        if not new_hosts or new_wid < 0:
            return None
        return {
            "slice_id": slice_id,
            "stamped_hosts": hosts,
            "new_hosts": new_hosts,
            "lost": sorted(set(hosts) - live),
            "joined": sorted(live - set(hosts)),
            "own_host": own_host,
            "new_worker_id": new_wid,
            "torn": torn,
            "accelerator_type": spec.get("env", {}).get(
                "TPU_ACCELERATOR_TYPE", ""
            ),
        }

    # -- repair ---------------------------------------------------------------

    def reform(self, owner, records: Dict[str, object], div: dict) -> int:
        """Execute one reform for one container; returns the new epoch.

        The registry advances first (idempotently per world), so every
        member container on this node restamps into the SAME epoch, and
        any concurrent rebind's ``pod_env`` stamp already sees the
        reformed world.
        """
        from ..plugins import gpushare

        slice_id = div["slice_id"]
        new_hosts = tuple(div["new_hosts"])
        epoch = self._registry.note_reform(slice_id, new_hosts)
        topo = parse_accelerator_type(div.get("accelerator_type", ""))
        env_updates = {}
        if topo is not None:
            topo_eff = topology_for_hosts(topo, len(new_hosts))
            env_updates.update(slice_env_from_topology(
                topo_eff, div["new_worker_id"], list(new_hosts)
            ))
        else:
            # No parseable shape (shouldn't happen for a stamped slice):
            # still re-emit the membership env — world size and identity
            # are what the survivors' rendezvous needs most.
            env_updates["TPU_WORKER_ID"] = str(div["new_worker_id"])
            env_updates["TPU_WORKER_HOSTNAMES"] = ",".join(new_hosts)
        env_updates[EnvSliceName] = slice_id
        env_updates[EnvSliceEpoch] = str(epoch)
        plugin = self._spec_plugin()
        with gpushare.bind_lock(owner.pod_key):
            restamped = plugin.restamp_spec_env_locked(
                owner, records, env_updates
            )
        if not restamped:
            # Specs vanished/corrupted between detection and repair: no
            # env changed, so succeeding here (epoch counted, event
            # emitted) would tell the runner a world it never received.
            # Raising routes this into slice_reform_failures and the
            # next pass re-detects whatever state remains.
            raise RuntimeError(
                f"slice {slice_id}: no alloc spec restamped for "
                f"{owner.pod_key} (specs vanished mid-pass)"
            )
        self._registry.record_local_pod(
            slice_id, owner.pod_key, div["new_worker_id"]
        )
        if self._timeline is not None:
            from ..timeline import KIND_SLICE_REFORMED

            self._timeline.emit(
                KIND_SLICE_REFORMED,
                keys={"pod": owner.pod_key, "container": owner.container,
                      "slice": slice_id},
                epoch=epoch, world=len(new_hosts),
                worker_id=div["new_worker_id"],
                lost=div["lost"], joined=div["joined"],
                hosts=",".join(new_hosts), torn=div.get("torn", False),
            )
        if self._events is not None:
            from ..kube.events import ReasonSliceReformed

            detail = []
            if div["lost"]:
                detail.append(f"lost {','.join(div['lost'])}")
            if div["joined"]:
                detail.append(f"joined {','.join(div['joined'])}")
            self._events.pod_event(
                owner.namespace, owner.name, ReasonSliceReformed,
                f"slice {slice_id} re-formed at world size "
                f"{len(new_hosts)} (epoch {epoch}"
                + (", " + "; ".join(detail) if detail else "")
                + f"); this worker is now id {div['new_worker_id']} — "
                "restart resumes from checkpoint at the new world size",
                type_="Warning",
            )
        logger.warning(
            "slice %s re-formed for %s: world %d -> %d (epoch %d, "
            "worker %d)", slice_id, owner.pod_key,
            len(div["stamped_hosts"]), len(new_hosts), epoch,
            div["new_worker_id"],
        )
        return epoch


__all__ = ["SliceReformer", "SliceMembershipError"]
