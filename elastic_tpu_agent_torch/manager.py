"""Manager: the node agent's wiring and lifecycle, and its restore.

The port's counterpart of ``elastic_tpu_agent/manager.py``'s
``TPUManager``, cut to the bind path: it opens the checkpoint store,
starts the supervisor, the apiserver client and the sitter (whose pod
deletions feed the GC queue), builds the device operator, the
pod-resources client with one snapshot source shared by the core and
memory locators, the plugin bundle and the reconciler; then ``run()``:

- the sitter syncs;
- ``restore()``: one reconciler pass with boot semantics, before the
  device-plugin servers exist, so that no bind can be in flight. It
  re-creates the links a reboot wiped, resolves the binds a crash cut
  short, reclaims pods deleted while the agent was down, sweeps orphans
  and replays unbound kubelet assignments;
- the device-plugin servers, GC, the health poll, the periodic reconciler
  and the deferred allocatable check start as supervised subsystems.

Nothing here imports torch (the agent's process holds no CUDA context) or
grpc: the pod-resources client is built from ``rpc`` only when no
``pod_resources_client`` is handed in, and the servers import grpc when
they start.

The agent's event bus, timeline and batcher, events, CRD recorder,
sampler, metrics, latency observatory and profiler, goodput, drain,
migration, repartition, slice registry and NRI server come with their
slices: their options and flags come with them.
"""

from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass
from typing import Optional

from . import supervisor as supervision
from .common import (
    DEVICE_PLUGIN_DIR,
    POD_RESOURCES_SOCKET,
    ResourceGPUCore,
    ResourceGPUMemory,
)
from .kube.client import KubeClient
from .kube.locator import KubeletDeviceLocator, PodResourcesSnapshotSource
from .kube.sitter import Sitter
from .plugins.base import GRPC_POOL_SIZE, PluginConfig
from .plugins.gpushare import (
    DEFAULT_ALLOC_SPEC_DIR,
    GPUSharePlugin,
    chip_of_device_id,
)
from .reconciler import DEFAULT_PERIOD_S, Reconciler
from .storage import Storage
from .supervisor import CRITICAL, DEGRADED, Supervisor
from .tracing import get_tracer

logger = logging.getLogger(__name__)


@dataclass
class ManagerOptions:
    """The agent's options of the ported subsystems, with its defaults
    (the GPU resources and operator where the agent's name TPU ones)."""

    node_name: str = ""
    db_path: str = "/host/var/lib/elastic-tpu/meta.db"
    kubeconfig: str = ""
    operator_kind: str = "nvidia"  # nvidia | stub[:<cards>] | exclusive[:<inner>]
    dev_root: str = "/host/dev"
    device_plugin_dir: str = DEVICE_PLUGIN_DIR
    pod_resources_socket: str = POD_RESOURCES_SOCKET
    alloc_spec_dir: str = DEFAULT_ALLOC_SPEC_DIR
    # gRPC worker threads per device-plugin resource server
    # (plugins/base.py; CLI --dp-pool-size)
    dp_pool_size: int = GRPC_POOL_SIZE
    # a subsystem crashing this many times inside the supervisor's window
    # is circuit-broken; a critical one then ends run(block=True)
    crash_loop_threshold: int = supervision.DEFAULT_CRASH_LOOP_THRESHOLD
    # the continuous reconciler: seconds between passes (jittered
    # 0.75x-1.25x); dry-run makes periodic passes observe only (the boot
    # pass always repairs)
    reconcile_period_s: float = DEFAULT_PERIOD_S
    reconcile_dry_run: bool = False
    # test seams: an apiserver client, an operator, and a pod-resources
    # client (an object with ``list()`` and
    # ``get_allocatable_resources()``, as ``rpc.PodResourcesClient``)
    kube_client: Optional[KubeClient] = None
    operator: object = None
    pod_resources_client: object = None


def build_operator(opts: ManagerOptions):
    """The device operator of ``opts.operator_kind``: ``nvidia`` (the
    host's cards through /dev/nvidia* and nvidia-smi), ``stub[:<cards>]``
    (that many fake H100s, 8 by default) or ``exclusive[:<inner>]``
    (whole cards, no virtual links, discovered by ``<inner>``, nvidia by
    default)."""
    if opts.operator is not None:
        return opts.operator
    from .device import ExclusiveOperator, NvidiaOperator, StubOperator

    kind = opts.operator_kind
    if kind == "exclusive" or kind.startswith("exclusive:"):
        from dataclasses import replace

        inner_kind = kind.partition(":")[2] or "nvidia"
        return ExclusiveOperator(
            build_operator(replace(opts, operator_kind=inner_kind)))
    if kind == "nvidia":
        return NvidiaOperator(opts.dev_root)
    if kind == "stub" or kind.startswith("stub:"):
        return StubOperator(opts.dev_root,
                            num_chips=int(kind.partition(":")[2] or 8))
    raise ValueError(f"unknown operator kind {kind!r}")


class NodeManager:
    def __init__(self, opts: ManagerOptions) -> None:
        self.storage = Storage(opts.db_path)
        self.supervisor = Supervisor(
            crash_loop_threshold=opts.crash_loop_threshold)
        self.client = opts.kube_client or KubeClient.auto(opts.kubeconfig)
        self.gc_queue: "queue.Queue" = queue.Queue()
        self.sitter = Sitter(self.client, opts.node_name,
                             on_delete=self.gc_queue.put)
        self.operator = build_operator(opts)
        pr_client = opts.pod_resources_client
        if pr_client is None:
            from . import rpc

            pr_client = rpc.PodResourcesClient(opts.pod_resources_socket)
        self.pr_client = pr_client
        # One pod-resources snapshot shared by the core and memory
        # locators and the reconciler: a cold core + memory bind pair
        # costs one kubelet List, and either resource's Allocate-time
        # prefetch warms both PreStarts.
        self.locator_source = PodResourcesSnapshotSource(pr_client)
        self.config = PluginConfig(
            node_name=opts.node_name,
            device_plugin_dir=opts.device_plugin_dir,
            pod_resources_socket=opts.pod_resources_socket,
            grpc_pool_size=opts.dp_pool_size,
            operator=self.operator,
            sitter=self.sitter,
            storage=self.storage,
            locator_factory=lambda res: KubeletDeviceLocator(
                res, source=self.locator_source),
            extra={"alloc_spec_dir": opts.alloc_spec_dir},
        )
        self.plugin = GPUSharePlugin(self.config)
        self.reconciler = Reconciler(
            storage=self.storage,
            operator=self.operator,
            plugin=self.plugin,
            sitter=self.sitter,
            snapshot_source=self.locator_source,
            alloc_spec_dir=opts.alloc_spec_dir,
            period_s=opts.reconcile_period_s,
            dry_run=opts.reconcile_dry_run,
        )
        self._stop = threading.Event()
        self._stopped = False

    # -- restore --------------------------------------------------------------

    def restore(self) -> dict:
        """Boot-time convergence: one reconciler pass with boot semantics
        (it acts at once: the device-plugin servers are not registered
        yet, so no bind can be in flight). The same logic then runs
        periodically as the supervised ``reconciler`` subsystem."""
        with get_tracer().trace("restore") as tr:
            report = self.reconciler.reconcile_once(boot=True)
            tr.set(**{
                k: v for k, v in report.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            })
        logger.info("restore report: %s", report)
        return report

    def check_allocatable_drift(self) -> Optional[dict]:
        """Cross-check the kubelet's allocatable devices (pod-resources v1
        GetAllocatableResources) against this agent's advertisement: a
        card the kubelet still counts that we no longer advertise (or the
        reverse) means the scheduler's arithmetic is wrong on this node.

        Returns {resource: {"missing": [cards], "extra": [cards]}} for the
        drifted resources, {} when in sync, None when the kubelet cannot
        answer (v1alpha1 only, or the allocatable gate off)."""
        if self.plugin.cordoned:
            # a drain cordon advertises every device Unhealthy by design
            return None
        try:
            resp = self.pr_client.get_allocatable_resources()
        except Exception as e:  # noqa: BLE001 - diagnostic, never fatal
            logger.warning("allocatable cross-check failed: %s", e)
            return None
        if resp is None:
            return None
        # cards we advertise Unhealthy are expected to be absent from the
        # kubelet's allocatable view
        ours = {c.index for c in self.operator.devices()}
        ours -= self.plugin.core.unhealthy_chips()
        drift: dict = {}
        for resource in (ResourceGPUCore, ResourceGPUMemory):
            seen: set = set()
            found = False
            for dev in resp.devices:
                if dev.resource_name != resource:
                    continue
                found = True
                for did in dev.device_ids:
                    chip = chip_of_device_id(did)
                    if chip is not None:
                        seen.add(chip)
            if not found:
                # the kubelet has not consumed our ListAndWatch yet (a
                # fresh boot): absence is indistinguishable from lag
                continue
            missing = sorted(ours - seen)
            extra = sorted(seen - ours)
            if missing or extra:
                drift[resource] = {"missing": missing, "extra": extra}
        if drift:
            logger.warning("allocatable drift vs kubelet: %s", drift)
        return drift

    _ALLOCATABLE_CHECK_DELAY_S = 10.0

    def _deferred_allocatable_check(self, stop: threading.Event) -> None:
        # Deferred: right after Register the kubelet has not consumed the
        # first ListAndWatch, so an immediate check would always cry
        # drift on a fresh boot. A supervised one-shot: a crash here is
        # retried with backoff instead of being swallowed.
        if stop.wait(self._ALLOCATABLE_CHECK_DELAY_S):
            return
        self.check_allocatable_drift()

    # -- run ------------------------------------------------------------------

    def run(self, block: bool = True) -> None:
        """Start the sitter, wait for its sync, restore, then start the
        device-plugin servers, GC, health, the reconciler and the
        allocatable check, each a supervised subsystem.

        ``block=True`` blocks on the supervisor's terminal event: the
        global stop, or a critical subsystem circuit-breaking."""
        self.supervisor.start(self._stop)
        # Sitter is CRITICAL: binds read annotations from its cache and GC
        # learns deletions through it.
        self.supervisor.register("sitter", self.sitter.run, CRITICAL)
        if not self.sitter.wait_synced(timeout=60.0):
            logger.warning("sitter not synced after 60s; continuing anyway")
        self.restore()
        # Device-plugin serve loops: one per extended resource, CRITICAL:
        # a dead ListAndWatch leaves the kubelet advertising stale devices.
        for server in self.plugin.servers:
            self.supervisor.register(
                f"device-plugin:{server.resource_name}", server.run, CRITICAL
            )
        self.supervisor.register(
            "gc", lambda stop: self.plugin.gc(self.gc_queue, stop), CRITICAL)
        self.supervisor.register("health", self.plugin.health_loop, DEGRADED)
        # DEGRADED: a broken reconciler leaves the node binding (with the
        # boot-converged state) while status() shows the loss.
        self.supervisor.register("reconciler", self.reconciler.run, DEGRADED)
        self.supervisor.register(
            "allocatable-check", self._deferred_allocatable_check, DEGRADED,
            one_shot=True,
        )
        if block:
            self.supervisor.wait_terminal()

    def stop(self) -> None:
        if self._stopped:  # idempotent: a double stop is harmless
            return
        self._stopped = True
        self._stop.set()
        self.gc_queue.put(None)  # wake GC so it can observe stop
        # the loops that write storage are joined before the db closes
        self.supervisor.join("gc", timeout=10.0)
        self.supervisor.join("health", timeout=10.0)
        self.supervisor.join("reconciler", timeout=10.0)
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        self.storage.close()
