"""Manager: the node agent's wiring and lifecycle, and its restore.

The port's counterpart of ``elastic_tpu_agent/manager.py``'s
``TPUManager``, cut to the bind path and its observability plane, wired
in the agent's order: the event bus (on by default), the checkpoint store
(with its group-commit window), the lifecycle timeline, the supervisor,
the apiserver client and the sitter (whose pod deletions feed the GC
queue and mark the detection-lag origin), the device operator, the
metrics' attachments, the latency observatory and detection-lag tracker,
the profiler, the tracer's slow-span listener, the CRD and Event
recorders, the pod-resources client with one snapshot source shared by
the core and memory locators, the plugin bundle and the reconciler; then
``run()``:

- ``agent_started`` is journaled and the build-info gauges set;
- the sitter syncs, and the card inventory is published to the CRD;
- ``restore()``: one reconciler pass with boot semantics, before the
  device-plugin servers exist, so that no bind can be in flight. It
  re-creates the links a reboot wiped, resolves the binds a crash cut
  short, reclaims pods deleted while the agent was down, sweeps orphans
  and replays unbound kubelet assignments;
- the device-plugin servers, GC, the health poll, the periodic reconciler,
  the profiler (with ``profile_hz`` > 0), the CRD and Event sink workers
  and the deferred allocatable check start as supervised subsystems.

Nothing here imports torch (the agent's process holds no CUDA context) or
grpc: the pod-resources client is built from ``rpc`` only when no
``pod_resources_client`` is handed in, and the servers import grpc when
they start. ``metrics`` is an ``AgentMetrics`` built by the caller (the
CLI's ``--metrics-port``); without it nothing imports prometheus_client.

The agent's utilization sampler, goodput ledger, drain, migration,
repartition, slice registry and NRI server come with their slices: their
options and flags come with them.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

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
        return NvidiaOperator(opts.dev_root)
    if kind == "stub" or kind.startswith("stub:"):
        return StubOperator(opts.dev_root,
                            num_chips=int(kind.partition(":")[2] or 8))
    raise ValueError(f"unknown operator kind {kind!r}")


class NodeManager:
    def __init__(self, opts: ManagerOptions) -> None:
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
        self._stop = threading.Event()
        self._stopped = False

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
        if self._opts.profile_hz > 0:
            # DEGRADED: observability never takes binding down; a crashed
            # profiler restarts with its table (same instance)
            self.supervisor.register("profiler", self.profiler.run, DEGRADED)
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
        self.supervisor.join("reconciler", timeout=10.0)
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        if self.crd_recorder is not None:
            self.crd_recorder.stop()
        if self.events is not None:
            self.events.stop()
        self.storage.close()
