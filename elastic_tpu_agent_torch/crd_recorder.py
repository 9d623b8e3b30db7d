"""Async ElasticTPU lifecycle recorder: bind/release -> CRD objects.

The port's copy of ``elastic_tpu_agent/crd_recorder.py``. Every bound
allocation is published as an ``ElasticTPU`` object (phase Bound, claimRef
-> pod/container, the card indexes, capacity in the port's resource
names); a released allocation is marked Released and then removed; each
card is published as an Available inventory object at boot (Failed while
unhealthy); the migration coordinator's records are published as
``Migrated`` objects; ``restore()`` reconciles the node's objects against the
checkpoint store. Object names are the agent's (``<node>-<hash>``,
``<node>-chip<index>``), so that a node switched between the agents keeps
its objects.

Writes go through ``async_sink.AsyncSink``, never inline: an apiserver
round-trip on the bind path would couple PreStart's latency to the
apiserver's health. Publication is observability, never load-bearing:
failures are logged and dropped, and after repeated consecutive failures
(the CRD not installed, RBAC denying us) the sink disables itself.
"""

from __future__ import annotations

import logging
from typing import Iterable, List, Optional

from .async_sink import AsyncSink, drop_hook, register_sink_metrics
from .common import GPUPercentEachCard, ResourceGPUCore, ResourceGPUMemory
from .crd import (
    ElasticTPU,
    ElasticTPUClient,
    PhaseAvailable,
    PhaseBound,
    PhaseFailed,
    PhaseReleased,
)

logger = logging.getLogger(__name__)


class CRDRecorder:
    """Publishes allocation lifecycle to the ElasticTPU CRD, off the hot
    path. All public methods are non-blocking and never raise."""

    def __init__(
        self,
        client: ElasticTPUClient,
        node_name: str,
        accelerator_type: str = "",
        metrics=None,
        flush_window_s: float = 0.0,
    ) -> None:
        self._client = client
        self._node = node_name
        self._accelerator_type = accelerator_type
        self._sink = AsyncSink(
            "crd-recorder", on_drop=drop_hook(metrics),
            flush_window_s=flush_window_s,
        )
        register_sink_metrics(self._sink, metrics)

    # -- public API (called from plugin bind / GC / manager restore) ----------

    def object_name(self, alloc_hash: str) -> str:
        # DNS-1123: node names are already DNS labels, hash is lowercase hex.
        return f"{self._node}-{alloc_hash}"

    def inventory_name(self, chip_index: int) -> str:
        return f"{self._node}-chip{chip_index}"

    def publish_inventory(self, chips) -> None:
        """Publish one Available-phase ElasticTPU object per discovered
        card, so that CRD consumers (external schedulers, dashboards) see
        the node's CAPACITY and not just its bindings. Called at boot and
        reconciled by restore()."""
        objs = [
            ElasticTPU(
                name=self.inventory_name(chip.index),
                node_name=self._node,
                capacity={
                    ResourceGPUCore: str(GPUPercentEachCard),
                    ResourceGPUMemory: str(chip.hbm_bytes // (1024 * 1024)),
                },
                chip_indexes=[chip.index],
                accelerator_type=self._accelerator_type,
                phase=PhaseAvailable,
                message=(
                    f"card {chip.index} ({chip.uuid}): "
                    f"{chip.hbm_bytes // (1024 ** 3)} GiB memory, "
                    f"{chip.cores} SM(s)"
                ),
            )
            for chip in chips
        ]

        def publish() -> None:
            for obj in objs:
                self._client.create(obj, update_existing=True)

        # coalescing key: only the newest queued inventory snapshot matters
        self._submit(publish, key="inventory")

    def record_bound(
        self,
        alloc_hash: str,
        resource: str,
        amount: int,
        namespace: str,
        pod: str,
        container: str,
        chip_indexes: List[int],
        trace_id: str = "",
    ) -> None:
        message = f"bound by elastic-tpu-agent on {self._node}"
        if trace_id:
            # the CRD record carries the bind's allocation-trace id so a
            # consumer can jump to the agent's /debug/traces dump
            message += f" [trace {trace_id}]"
        obj = ElasticTPU(
            name=self.object_name(alloc_hash),
            node_name=self._node,
            capacity={resource: str(amount)},
            chip_indexes=list(chip_indexes),
            accelerator_type=self._accelerator_type,
            claim_namespace=namespace,
            claim_name=pod,
            claim_container=container,
            phase=PhaseBound,
            message=message,
        )
        # keyed per object: a queued-but-unwritten Bound for this hash is
        # superseded by a newer write (e.g. its Released) instead of both
        # hitting the apiserver
        self._submit(
            lambda: self._client.create(obj, update_existing=True),
            key=("obj", obj.name),
        )

    def record_chip_health(
        self, chip_index: int, healthy: bool, reason: str = ""
    ) -> None:
        """Flip the card's inventory object between Available and Failed
        on health transitions, so that an external scheduler reading the
        CRD stops placing onto a dead card."""
        name = self.inventory_name(chip_index)
        if healthy:
            phase, message = PhaseAvailable, "card recovered"
        else:
            phase, message = PhaseFailed, reason or "card unhealthy"

        self._submit(
            lambda: self._client.update_status(name, phase, message),
            key=("chip", chip_index),
        )

    def record_migration(self, obj: ElasticTPU) -> None:
        """Publish or refresh a MigrationRecord (migration.py), keyed by
        its name so that a re-publish supersedes a queued one. The
        coordinator confirms by reading it back and re-submits until it
        is there: its journal, not this queue, is the durable copy."""
        self._submit(
            lambda: self._client.create(obj, update_existing=True),
            key=("obj", obj.name),
        )

    def record_released(self, alloc_hash: str) -> None:
        name = self.object_name(alloc_hash)

        def release() -> None:
            try:
                self._client.update_status(
                    name, PhaseReleased, "reclaimed by elastic-tpu-agent"
                )
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
            self._client.delete(name)

        self._submit(release, key=("obj", name))

    def reconcile(
        self,
        live_hashes: Iterable[str],
        chip_indexes: Iterable[int] = (),
    ) -> None:
        """Restore-time sweep: delete objects this node published for
        allocations that no longer exist in the checkpoint store, and
        inventory objects for cards no longer present (keeps the ones that
        are — publish_inventory upserts them)."""
        live = {self.object_name(h) for h in live_hashes}
        live |= {self.inventory_name(i) for i in chip_indexes}

        def sweep() -> None:
            for obj in self._client.list(self._node):
                if obj.name not in live:
                    logger.info("crd reconcile: removing stale %s", obj.name)
                    self._client.delete(obj.name)

        self._submit(sweep, key="reconcile")

    # -- lifecycle ------------------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        return self._sink.flush(timeout=timeout)

    def stop(self, timeout: float = 30.0) -> None:
        # Generous default: stop() DRAINS (async_sink) — capping it at a
        # few seconds would re-introduce the abandoned-queue shutdown.
        self._sink.stop(timeout=timeout)

    def run_supervised(self, stop) -> None:
        """Supervisor target (supervisor.py): watchdog over the sink's
        internal worker thread."""
        self._sink.run_supervised(stop)

    @property
    def disabled(self) -> bool:
        return self._sink.disabled

    def _submit(self, op, key=None) -> None:
        self._sink.submit(op, key=key)


def build_recorder(
    kube_client, node_name: str, operator, metrics=None,
    flush_window_s: float = 0.0,
) -> Optional[CRDRecorder]:
    """Manager-side constructor: a recorder bound to this node's client and
    card product name (the operator's ``topology.accelerator_type``); None
    when there is no kube client or node name."""
    if kube_client is None or not node_name:
        return None
    acc = ""
    topo = getattr(operator, "topology", None)
    if topo is not None:
        acc = getattr(topo, "accelerator_type", "") or ""
    return CRDRecorder(
        ElasticTPUClient(kube_client), node_name, accelerator_type=acc,
        metrics=metrics, flush_window_s=flush_window_s,
    )
