"""Manager: the node agent's wiring and lifecycle, and its restore.

The port's counterpart of ``elastic_tpu_agent/manager.py``'s
``TPUManager``: the bind path, its observability plane, the utilization
sampler, the drain, the migration handshake, live re-partitioning and the
goodput ledger, wired in the agent's
order: the event bus (on by default), the checkpoint store (with its
group-commit window), the lifecycle timeline, the supervisor, the
apiserver client and the sitter (whose pod deletions feed the GC queue
and mark the detection-lag origin), the device operator, the metrics'
attachments, the latency observatory and detection-lag tracker, the
profiler, the tracer's slow-span listener, the CRD and Event recorders,
the utilization sampler, the pod-resources client with one snapshot
source shared by the core and memory locators, the plugin bundle (which
folds the sampler's flags into its health), the reconciler, the drain
orchestrator, the migration coordinator (both assigned to the reconciler,
and the coordinator to the drain), the repartition controller (with the
sampler only: the sampler is its usage signal; assigned to the reconciler,
its deltas to the sampler's grants, the coordinator to it) and the goodput
ledger (always, attached to ``/debug/goodput``); then ``run()``:

- ``agent_started`` is journaled and the build-info gauges set;
- the sitter syncs, and the card inventory is published to the CRD;
- the drain's, the coordinator's and the controller's journaled state
  and the ledger's anchors are resumed (the cordon back up, replay
  suppression armed, quotas re-asserted) before the boot pass, which
  would otherwise replay the bindings a drain or an eviction reclaimed;
- ``restore()``: one reconciler pass with boot semantics, before the
  device-plugin servers exist, so that no bind can be in flight. It
  re-creates the links a reboot wiped, resolves the binds a crash cut
  short, reclaims pods deleted while the agent was down, sweeps orphans
  and replays unbound kubelet assignments;
- the device-plugin servers, GC, the health poll, the periodic reconciler,
  the drain, the migration coordinator, the repartition controller, the
  sampler, the profiler (with ``profile_hz`` > 0), the goodput ledger,
  the NRI server (with ``nri_socket``), the CRD and
  Event sink workers and the deferred allocatable check start as
  supervised subsystems.

With ``nri_socket`` the agent registers as an external NRI plugin on the
runtime's socket and injects the allocation at CreateContainer (the
containerd activation; the OCI hook chain in ``native/`` is the other),
and with ``nri_evict_on_chip_failure`` a card that goes unhealthy evicts
the containers injected with it.

Nothing here imports torch (the agent's process holds no CUDA context) or
grpc: the pod-resources client is built from ``rpc`` only when no
``pod_resources_client`` is handed in, and the servers import grpc when
they start. ``metrics`` is an ``AgentMetrics`` built by the caller (the
CLI's ``--metrics-port``); without it nothing imports prometheus_client.

The agent's slice registry comes with its slice, and so do its options
and flags.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from . import supervisor as supervision
from . import timeline as timeline_mod
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
    # the device-plugin bundle: gpushare (gpu-core and gpu-memory) is the
    # port's one kind, as tpushare is the agent's
    plugin_kind: str = "gpushare"
    operator_kind: str = "nvidia"  # nvidia | stub[:<cards>] | exclusive[:<inner>]
    dev_root: str = "/host/dev"
    device_plugin_dir: str = DEVICE_PLUGIN_DIR
    pod_resources_socket: str = POD_RESOURCES_SOCKET
    alloc_spec_dir: str = DEFAULT_ALLOC_SPEC_DIR
    # the containerd activation (nri/plugin.py): register as an external
    # NRI plugin on this socket and inject at CreateContainer ("" = off)
    nri_socket: str = ""
    # host driver libraries (libcuda.so.1, ...) bind-mounted read-only at
    # their own paths into GPU containers through NRI (the agent's
    # nri_libtpu; empty = the images carry their own)
    nri_driver_libs: List[str] = field(default_factory=list)
    # policy (off by default): a card that goes unhealthy evicts, through
    # NRI UpdateContainers, the containers injected with it; the kubelet
    # restarts them on healthy cards
    nri_evict_on_chip_failure: bool = False
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
    # publish bound allocations and the card inventory as ElasticTPU
    # objects (crd_recorder.py); auto-disables when the CRD is absent
    enable_crd: bool = True
    # post core/v1 Events on binds, reclaims and restores (kube/events.py)
    enable_events: bool = True
    # ring cap of the durable lifecycle journal (timeline.py; CLI
    # --timeline-cap)
    timeline_cap: int = timeline_mod.DEFAULT_CAP
    # slow-span threshold in milliseconds (CLI --slow-span-ms; None = the
    # tracer's default or ELASTIC_TPU_SLOW_SPAN_MS); slow spans land in
    # the timeline as slow_span events
    slow_span_ms: Optional[float] = None
    # sampling profiler rate (profiler.py; CLI --profile-hz; 0 = off)
    profile_hz: float = 0.0
    # group-commit window of the store (storage/batcher.py; CLI
    # --storage-batch-window; 0 = every write commits itself)
    storage_batch_window_s: float = 0.0
    # coalescing window of the CRD and Event sinks (async_sink.py; CLI
    # --sink-flush-window)
    sink_flush_window_s: float = 0.0
    # the in-process event bus (events.py): pod deltas, assignment deltas
    # and store-change notifications wake the reconciler, whose periodic
    # sweep stretches by event_safety_net_factor while the bus is healthy.
    # False = plain polling (CLI --no-event-bus /
    # --event-safety-net-factor)
    enable_event_bus: bool = True
    event_safety_net_factor: float = 10.0
    # the utilization sampler (sampler.py): each card's duty and used
    # memory joined against the store, for /metrics, /debug/allocations
    # and node-doctor; its flags fold into the health poll (CLI
    # --no-sampler / --sampler-period)
    enable_sampler: bool = True
    sampler_period_s: float = 10.0
    # the drain (drain.py): the checkpoint deadline between the signal and
    # the reclaim, and the trigger-poll period (jittered 0.75x-1.25x)
    # (CLI --drain-deadline / --drain-period)
    drain_deadline_s: float = 300.0
    drain_period_s: float = 2.0
    # a spot host's preemption notice: a preemption drain's budget is
    # min(deadline, notice) (CLI --preemption-notice; 0 = no clamp)
    preemption_notice_s: float = 30.0
    # how long one maintenance/preempted metadata read stays cached (None:
    # the operator's default; CLI --maintenance-poll-ttl)
    maintenance_poll_ttl_s: Optional[float] = None
    # the migration coordinator (migration.py): acks consumed, drains
    # completed early, records published, resumes verified (CLI
    # --no-migration / --migration-period)
    enable_migration: bool = True
    migration_period_s: float = 2.0
    # live re-partitioning (repartition.py) for pods that opt in through
    # elasticgpu.io/repartition, with throttle -> evict for a sustained
    # overcommit; needs the sampler, its usage signal (CLI
    # --no-repartition / --repartition-period / --qos-evict-after)
    enable_repartition: bool = True
    repartition_period_s: float = 10.0
    qos_evict_after_s: float = 300.0
    # the goodput ledger's journal-replay period (goodput.py; CLI
    # --goodput-period)
    goodput_period_s: float = 10.0
    # test seams: an apiserver client, an operator, a pod-resources
    # client (an object with ``list()`` and
    # ``get_allocatable_resources()``, as ``rpc.PodResourcesClient``) and
    # an AgentMetrics (metrics.py)
    kube_client: Optional[KubeClient] = None
    operator: object = None
    pod_resources_client: object = None
    metrics: object = None


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
        return NvidiaOperator(
            opts.dev_root, maintenance_poll_ttl_s=opts.maintenance_poll_ttl_s)
    if kind == "stub" or kind.startswith("stub:"):
        return StubOperator(opts.dev_root,
                            num_chips=int(kind.partition(":")[2] or 8))
    raise ValueError(f"unknown operator kind {kind!r}")


class NodeManager:
    def __init__(self, opts: ManagerOptions) -> None:
        if opts.plugin_kind != "gpushare":
            raise ValueError(f"unknown plugin kind {opts.plugin_kind!r}")
        self._opts = opts
        # The bus first: the store publishes its notifications from its
        # commit path, so the bus exists before the first write.
        self.bus = None
        if opts.enable_event_bus:
            from . import events as events_mod

            self.bus = events_mod.EventBus()
        self.storage = Storage(
            opts.db_path, batch_window_s=opts.storage_batch_window_s,
            bus=self.bus,
        )
        # The journal rides the checkpoint db; made before the supervisor
        # so that even its bring-up is journaled.
        self.timeline = timeline_mod.Timeline(
            self.storage, node_name=opts.node_name, metrics=opts.metrics,
            cap=opts.timeline_cap,
        )
        self.metrics = opts.metrics
        self.supervisor = Supervisor(
            metrics=self.metrics,
            crash_loop_threshold=opts.crash_loop_threshold,
            timeline=self.timeline,
        )
        self.client = opts.kube_client or KubeClient.auto(opts.kubeconfig)
        self.gc_queue: "queue.Queue" = queue.Queue()
        from .latency import BindLatencyObservatory, DetectionLagTracker
        from .profiler import SamplingProfiler

        self.lag_tracker = DetectionLagTracker(metrics=self.metrics)
        self.sitter = Sitter(self.client, opts.node_name,
                             on_delete=self._on_pod_deleted, bus=self.bus)
        self.operator = build_operator(opts)
        if self.metrics is not None:
            self.metrics.attach_supervisor(self.supervisor)
            self.metrics.attach_sitter(self.sitter)
            self.metrics.attach_storage(self.storage)
            self.metrics.attach_timeline(self.timeline)
            try:
                n = len(self.operator.devices())
                self.metrics.chips.set(n)
                self.metrics.healthy_chips.set(n)
            except Exception:  # noqa: BLE001 - discovery failed: gauge stays 0
                logger.exception("card discovery for metrics failed")
        # The bind latency observatory and the slow-span journal listen
        # on the process-wide tracer, filtered to this node's traces
        # (stop() removes both).
        self.latency = BindLatencyObservatory(
            metrics=self.metrics, node_name=opts.node_name)
        self.profiler = SamplingProfiler(hz=opts.profile_hz)
        tracer = get_tracer()
        if opts.slow_span_ms is not None:
            tracer.slow_span_s = max(0.0, opts.slow_span_ms / 1000.0)
        tracer.add_listener(self.latency.observe_trace)
        tracer.add_slow_span_listener(self._on_slow_span)
        if self.metrics is not None:
            self.metrics.attach_latency(self.latency, self.lag_tracker)
            self.metrics.attach_profiler(self.profiler)
        self.crd_recorder = None
        if opts.enable_crd:
            from .crd_recorder import build_recorder

            self.crd_recorder = build_recorder(
                self.client, opts.node_name, self.operator,
                metrics=self.metrics,
                flush_window_s=opts.sink_flush_window_s,
            )
        self.events = None
        if opts.enable_events:
            from .kube.events import build_event_recorder

            self.events = build_event_recorder(
                self.client, opts.node_name, metrics=self.metrics,
                flush_window_s=opts.sink_flush_window_s,
            )
        self.sampler = None
        if opts.enable_sampler:
            from .sampler import UtilizationSampler

            self.sampler = UtilizationSampler(
                self.operator, storage=self.storage, metrics=self.metrics,
                alloc_spec_dir=opts.alloc_spec_dir,
                period_s=opts.sampler_period_s,
                lag_tracker=self.lag_tracker, bus=self.bus,
            )
            if self.metrics is not None:
                self.metrics.attach_sampler(self.sampler)
        pr_client = opts.pod_resources_client
        if pr_client is None:
            from . import rpc

            pr_client = rpc.PodResourcesClient(opts.pod_resources_socket)
        self.pr_client = pr_client
        # One pod-resources snapshot shared by the core and memory
        # locators and the reconciler: a cold core + memory bind pair
        # costs one kubelet List, and either resource's Allocate-time
        # prefetch warms both PreStarts.
        self.locator_source = PodResourcesSnapshotSource(
            pr_client, metrics=self.metrics, bus=self.bus)
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
            metrics=self.metrics,
            crd_recorder=self.crd_recorder,
            events=self.events,
            timeline=self.timeline,
            lag_tracker=self.lag_tracker,
            sampler=self.sampler,
            extra={"alloc_spec_dir": opts.alloc_spec_dir},
        )
        self.plugin = GPUSharePlugin(self.config)
        if self.sampler is not None:
            self.sampler.locator_stats_fn = self.plugin.locator_stats
            self.sampler.bind_stats_fn = self.plugin.bind_stats
            # the plugin's applied health view, not an operator probe from
            # the debug handler's thread
            self.sampler.unhealthy_view_fn = self.plugin.core.unhealthy_chips
        self.reconciler = Reconciler(
            storage=self.storage,
            operator=self.operator,
            plugin=self.plugin,
            sitter=self.sitter,
            snapshot_source=self.locator_source,
            alloc_spec_dir=opts.alloc_spec_dir,
            metrics=self.metrics,
            events=self.events,
            crd_recorder=self.crd_recorder,
            period_s=opts.reconcile_period_s,
            dry_run=opts.reconcile_dry_run,
            timeline=self.timeline,
            lag_tracker=self.lag_tracker,
            bus=self.bus,
            event_safety_net_factor=opts.event_safety_net_factor,
        )
        from .drain import DrainOrchestrator

        self.drain = DrainOrchestrator(
            operator=self.operator, plugin=self.plugin,
            storage=self.storage, sitter=self.sitter,
            reconciler=self.reconciler, kube_client=self.client,
            events=self.events, metrics=self.metrics,
            node_name=opts.node_name, deadline_s=opts.drain_deadline_s,
            preemption_notice_s=opts.preemption_notice_s,
            period_s=opts.drain_period_s, timeline=self.timeline,
            lag_tracker=self.lag_tracker, bus=self.bus,
            event_safety_net_factor=opts.event_safety_net_factor,
        )
        # while the drain has reclaimed bindings, the kubelet's listed
        # assignments are not replayed
        self.reconciler.drain = self.drain
        self.migration = None
        if opts.enable_migration:
            from .migration import MigrationCoordinator

            self.migration = MigrationCoordinator(
                storage=self.storage, plugin=self.plugin,
                sitter=self.sitter, reconciler=self.reconciler,
                drain=self.drain, kube_client=self.client,
                crd_recorder=self.crd_recorder, events=self.events,
                metrics=self.metrics, node_name=opts.node_name,
                alloc_spec_dir=opts.alloc_spec_dir,
                period_s=opts.migration_period_s, timeline=self.timeline,
                lag_tracker=self.lag_tracker, bus=self.bus,
                event_safety_net_factor=opts.event_safety_net_factor,
            )
            # early-reclaimed residents are not replayed; the drain
            # classifies its outcome by the acks
            self.reconciler.migration = self.migration
            self.drain.migration = self.migration
        # live re-partitioning: the sampler is its usage signal, so no
        # sampler means no controller
        self.repartition = None
        if opts.enable_repartition and self.sampler is not None:
            from .repartition import RepartitionController

            self.repartition = RepartitionController(
                sampler=self.sampler, storage=self.storage,
                sitter=self.sitter, plugin=self.plugin,
                reconciler=self.reconciler, metrics=self.metrics,
                events=self.events, timeline=self.timeline,
                node_name=opts.node_name,
                period_s=opts.repartition_period_s,
                evict_after_s=opts.qos_evict_after_s,
                lag_tracker=self.lag_tracker, bus=self.bus,
                event_safety_net_factor=opts.event_safety_net_factor,
            )
            # evicted pods are not replayed; the overcommit alarm judges
            # the effective grant; a throttled pod's checkpoint ack gates
            # (and can advance) its eviction
            self.reconciler.repartition = self.repartition
            self.sampler.grant_adjust_fn = (
                self.repartition.core_delta_percent)
            self.sampler.repartition_status_fn = self.repartition.status
            self.repartition.migration = self.migration
        if self.sampler is not None:
            # self-reports steer attribution (and enforcement), so only
            # opted-in pods' usage files are trusted, with the controller
            # off too
            self.sampler.usage_report_allowed_fn = self._report_allowed
            self.sampler.reconcile_status_fn = self.reconciler.status
            self.sampler.drain_status_fn = self.drain.status
            if self.migration is not None:
                self.sampler.migration_status_fn = self.migration.status
            if self.bus is not None:
                self.sampler.event_bus_stats_fn = self.bus.stats
        # the goodput ledger replays the journal the subsystems above
        # write, so it needs no hooks into them
        from .goodput import GoodputLedger

        self.goodput = GoodputLedger(
            storage=self.storage, node_name=opts.node_name,
            metrics=self.metrics, migration=self.migration,
            period_s=opts.goodput_period_s, lag_tracker=self.lag_tracker,
        )
        if self.metrics is not None:
            self.metrics.attach_goodput(self.goodput)
        self.nri_plugin = None
        if opts.nri_socket:
            from .nri import NRIPlugin

            # runc resolves an adjustment's Mount.source in the host's
            # mount namespace, and the agent sees the host under /host
            host_alloc = opts.alloc_spec_dir
            if host_alloc.startswith("/host/"):
                host_alloc = host_alloc[len("/host"):]
            self.nri_plugin = NRIPlugin(
                socket_path=opts.nri_socket,
                alloc_spec_dir=opts.alloc_spec_dir,
                host_alloc_dir=host_alloc,
                dev_root=opts.dev_root,
                driver_libs=opts.nri_driver_libs,
                metrics=self.metrics,
            )
            if opts.nri_evict_on_chip_failure:
                self.plugin.on_chips_failed = self.nri_plugin.evict_for_chips
                self.plugin.on_chips_recovered = (
                    self.nri_plugin.clear_failed_chips)
        self._stop = threading.Event()
        self._stopped = False

    def _report_allowed(self, pod_key: str) -> bool:
        """Whether a pod's usage self-reports are trusted: it opted into
        repartitioning (``elasticgpu.io/repartition``)."""
        from .device.qos import repartition_opt_in

        ns, _, name = pod_key.partition("/")
        pod = self.sitter.get_pod(ns, name)
        if pod is None:
            return False
        return repartition_opt_in(
            (pod.get("metadata") or {}).get("annotations") or {})

    def _on_pod_deleted(self, pod: dict) -> None:
        """The sitter's delete hook: stamp the deletion as the origin of
        the reclaim's detection lag, then wake GC."""
        namespace, name = Sitter._key(pod)
        self.lag_tracker.mark("reclaimed_pod", f"{namespace}/{name}")
        self.gc_queue.put(pod)

    def _on_slow_span(self, tr, sp) -> None:
        """A span over the tracer's threshold lands in the timeline, keyed
        by pod and trace (this node's traces only)."""
        node = str(tr.attrs.get("node", ""))
        if self._opts.node_name and node and node != self._opts.node_name:
            return
        pod = str(tr.attrs.get("pod", "")
                  or ((tr.attrs.get("pods") or [""]) or [""])[0])
        self.timeline.emit(
            timeline_mod.KIND_SLOW_SPAN,
            keys={"pod": pod, "trace": tr.trace_id},
            span=sp.name,
            duration_ms=round(sp.duration_s * 1000, 3),
            threshold_ms=round(get_tracer().slow_span_s * 1000, 3),
            op=tr.name,
        )

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
        replayed = (
            report["intents_committed"] + report["intents_rolled_back"]
            + report["replayed_binds"] + report["rebound_drift"]
        )
        if self.events is not None and (
            report["restored_links"] or report["reclaimed_pods"]
            or report["orphan_links"] or report["orphan_specs"] or replayed
        ):
            from .kube.events import ReasonRestored

            self.events.node_event(
                ReasonRestored,
                "agent restart reconcile: "
                f"{report['restored_links']} link(s) restored, "
                f"{report['reclaimed_pods']} dead pod(s) reclaimed, "
                f"{report['orphan_links'] + report['orphan_specs']} "
                "orphan artifact(s) swept, "
                f"{replayed} interrupted bind(s) recovered",
            )
        if self.metrics is not None:
            self.metrics.restored_links.inc(report["restored_links"])
            self.metrics.bound_allocations.set(self.storage.count())
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
            if self.events is not None:
                from .kube.events import ReasonAllocatableDrift

                parts = []
                for resource, d in sorted(drift.items()):
                    if d["missing"]:
                        parts.append(
                            f"{resource}: kubelet missing card(s) "
                            f"{','.join(map(str, d['missing']))}")
                    if d["extra"]:
                        parts.append(
                            f"{resource}: kubelet still counts absent "
                            f"card(s) {','.join(map(str, d['extra']))}")
                self.events.node_event(
                    ReasonAllocatableDrift,
                    "kubelet allocatable view disagrees with agent "
                    "advertisement — " + "; ".join(parts),
                    type_="Warning",
                )
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
        from . import __version__

        # agent_started first: a history read across restarts shows the
        # boot boundary before any event this process emits
        self.timeline.emit(timeline_mod.KIND_AGENT_STARTED,
                           version=__version__,
                           boot_id=self.timeline.boot_id)
        if self.metrics is not None:
            self.metrics.build_info.labels(version=__version__).set(1)
            self.metrics.agent_start_time.set(time.time())
        self.supervisor.start(self._stop)
        # Sitter is CRITICAL: binds read annotations from its cache and GC
        # learns deletions through it.
        self.supervisor.register("sitter", self.sitter.run, CRITICAL)
        if not self.sitter.wait_synced(timeout=60.0):
            logger.warning("sitter not synced after 60s; continuing anyway")
        if self.crd_recorder is not None:
            # capacity first: CRD readers see the node's cards as
            # Available inventory from boot
            try:
                self.crd_recorder.publish_inventory(self.operator.devices())
            except Exception:  # noqa: BLE001 - observability, never fatal
                logger.exception("inventory publication failed")
        # the journaled drain, handshake and quota state before the boot
        # pass: a node restarted mid-drain re-cordons and arms replay
        # suppression first, or restore() would replay what the drain or
        # a QoS eviction reclaimed; a crash mid-restamp converges before
        # binds resume; the ledger's anchors before its first replay
        self.drain.resume()
        if self.migration is not None:
            self.migration.resume()
        if self.repartition is not None:
            self.repartition.resume()
        self.goodput.resume()
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
        # DEGRADED: losing the drain or the handshake never takes binding
        # down (drains then run to their deadline); resume() re-enters the
        # journaled state on every start
        self.supervisor.register("drain", self.drain.run, DEGRADED)
        if self.migration is not None:
            self.supervisor.register("migration", self.migration.run,
                                     DEGRADED)
        if self.repartition is not None:
            # DEGRADED: without it the static grants stay in force
            self.supervisor.register("repartition", self.repartition.run,
                                     DEGRADED)
        if self.sampler is not None:
            self.supervisor.register("sampler", self.sampler.run, DEGRADED)
        if self._opts.profile_hz > 0:
            # DEGRADED: observability never takes binding down; a crashed
            # profiler restarts with its table (same instance)
            self.supervisor.register("profiler", self.profiler.run, DEGRADED)
        # DEGRADED: the journal accrues either way, and the next tick
        # replays it all
        self.supervisor.register("goodput", self.goodput.run, DEGRADED)
        if self.nri_plugin is not None:
            # DEGRADED: without NRI the node still binds, and the OCI hook
            # chain still injects where the runtime reads hooks.d
            self.supervisor.register("nri", self.nri_plugin.run, DEGRADED)
        if self.crd_recorder is not None:
            self.supervisor.register(
                "crd-recorder", self.crd_recorder.run_supervised, DEGRADED)
        if self.events is not None:
            self.supervisor.register(
                "events", self.events.run_supervised, DEGRADED)
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
        # detach from the process-wide tracer: a later manager in this
        # process must not feed this one's observatory
        tracer = get_tracer()
        tracer.remove_listener(self.latency.observe_trace)
        tracer.remove_slow_span_listener(self._on_slow_span)
        self.gc_queue.put(None)  # wake GC so it can observe stop
        # The loops that write storage or submit to the sinks are joined
        # before the sinks drain and the db closes: an in-flight gc_once()
        # may still enqueue a release.
        self.supervisor.join("gc", timeout=10.0)
        self.supervisor.join("health", timeout=10.0)
        self.supervisor.join("sampler", timeout=10.0)
        self.supervisor.join("reconciler", timeout=10.0)
        # the drain and the coordinator journal, reclaim and publish
        self.supervisor.join("drain", timeout=10.0)
        self.supervisor.join("migration", timeout=10.0)
        # the controller journals and restamps specs, the ledger reads
        # the journal and writes its anchors: both before the db closes
        self.supervisor.join("repartition", timeout=10.0)
        self.supervisor.join("goodput", timeout=10.0)
        if self.nri_plugin is not None:
            self.nri_plugin.stop()
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        if self.crd_recorder is not None:
            self.crd_recorder.stop()
        if self.events is not None:
            self.events.stop()
        self.storage.close()
