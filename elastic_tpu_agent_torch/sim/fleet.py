"""FleetSim: N in-process agents, N fake kubelets, ONE fake apiserver.

The port's copy of ``elastic_tpu_agent/sim/fleet.py``, over the port's
agents. Every node is a complete agent — real NodeManager (the
``gpushare`` plugins, gpu-core units), real gRPC device-plugin
servers registered with its own FakeKubelet (the port's,
``tests/torch_fake_kubelet.py``), real supervised reconciler,
real CRD/Event sinks writing to the shared FakeAPIServer — with its own
AgentMetrics on a private registry served on an ephemeral loopback port,
so the FleetAggregator reads the fleet exactly the way a production
Prometheus would: one scrape target per node.

The bind drive is in-process (the Allocate/PreStartContainer servicers
are invoked directly, like the bench churn phase): on the small CI box,
per-RPC gRPC overhead at fleet concurrency would benchmark the loopback
fabric instead of the agent. The pod-resources Lists the locators and
reconcilers issue still cross real gRPC to each node's fake kubelet, and
the sinks still cross real HTTP to the shared apiserver — the traffic
the fleet observatory meters is real.

Admission stamps ``elasticgpu.io/trace-id`` on every pod, so one trace
id follows the pod from the shared apiserver to whichever agent binds it
(the bind adopts the id; plugins/gpushare.py). All in-process agents
share the one process-wide trace ring, so bind traces also carry a
``node`` attribute — the aggregator attributes a trace to its binding
node by that attribute, exactly as it would pick the one answering ring
in a real multi-process fleet.

Where the agent's sim names TPU things the port names its own: the
operator kinds follow the port's grammar (``stub:<cards>``, ``nvidia``),
slices are admitted as ``h100-sxm5-<cards>``, the pods' one container is
``main``, and pods land on the node's own card indexes
(:meth:`FleetSim.chip_indexes`: a real card's index is its node minor).
A node's operator object can be handed in by a subclass
(:meth:`FleetSim._operator_for`), so that a node can be a real card whose
metadata fetchers are the caller's.
"""

from __future__ import annotations

import os
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

from ..common import (
    AnnotationAssumed,
    AnnotationSliceID,
    AnnotationSliceName,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
    AnnotationTraceID,
    EnvSliceEpoch,
    ResourceGPUCore,
    container_annotation,
)
from ..gen import deviceplugin_pb2 as dp
from ..kube.client import KubeClient
from ..manager import ManagerOptions, NodeManager
from ..tracing import Tracer, new_trace_id, set_tracer

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))

# the one container of every simulated pod
CONTAINER = "main"


def _import_fakes():
    """The fake control-plane rigs live in tests/ (they are test/bench
    material, not agent code); make them importable from tooling without
    an installed package. The kubelet is the port's own fake
    (``torch_fake_kubelet``), which loads nothing of the JAX package; the
    apiserver's uses the standard library only."""
    tests_dir = os.path.join(_REPO, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    try:
        from fake_apiserver import FakeAPIServer, make_pod
        from torch_fake_kubelet import FakeKubelet
    except ImportError as e:  # pragma: no cover - repo layout broken
        raise RuntimeError(
            "FleetSim needs tests/fake_apiserver.py and "
            "tests/torch_fake_kubelet.py next to the package "
            f"(looked in {tests_dir}): {e}"
        ) from e
    return FakeAPIServer, FakeKubelet, make_pod


class SimNode:
    """One simulated node: fake kubelet + full agent + metrics endpoint."""

    def __init__(self, name: str, root: str) -> None:
        self.name = name
        self.root = root
        self.kubelet = None
        self.manager: Optional[NodeManager] = None
        self.metrics = None
        self.metrics_url: str = ""
        self.dead = False  # killed by a chaos scenario (kill_node)
        self.opts: Optional[ManagerOptions] = None  # kept for restart_node
        self.operator_kind: str = ""

    @property
    def storage(self):
        return self.manager.storage


class PodRef:
    """One admitted pod: where it was scheduled and its admission id."""

    __slots__ = ("node_idx", "namespace", "name", "chip", "trace_id")

    def __init__(self, node_idx, namespace, name, chip, trace_id) -> None:
        self.node_idx = node_idx
        self.namespace = namespace
        self.name = name
        self.chip = chip
        self.trace_id = trace_id

    @property
    def pod_key(self) -> str:
        return f"{self.namespace}/{self.name}"


class SimWorkload:
    """Stub in-pod workload for migration chaos scenarios: a thread
    ticking a step counter with the REAL LifecycleWatcher woven in —
    the same spec-polling / atomic-ack code path a production runner
    uses — writing stub checkpoints (a state file whose digest the ack
    carries) to a shared 'PVC' directory. On a drain or reform signal
    it saves, acks and (for drains) exits, exactly the contract
    workloads/lifecycle.py documents; a replacement pod finds the
    destination agent's restore stamp, adopts the checkpointed step and
    acks the resume for verification."""

    def __init__(
        self,
        alloc_spec_dir: str,
        alloc_hash: str,
        ckpt_dir: str,
        tick_s: float = 0.02,
        resume_wait_s: float = 0.0,
        exit_on_drain: bool = True,
        precopy: bool = False,
        state_bytes: int = 0,
        dirty_fraction: float = 0.05,
        precopy_interval_ticks: int = 2,
        ship_bps: float = 0.0,
    ) -> None:
        from ..workloads.lifecycle import LifecycleWatcher

        self.ckpt_dir = ckpt_dir
        self.tick_s = tick_s
        self.resume_wait_s = resume_wait_s
        self.exit_on_drain = exit_on_drain
        # Pre-copy mode: the workload carries a synthetic
        # mutable parameter blob; on a drain it STREAMS delta rounds
        # through a DeltaCheckpointer while training continues, then
        # pauses only for the final delta at the coordinator's cutover
        # signal. ship_bps simulates shared-storage bandwidth — the
        # sleep per shipped byte is what makes the full-vs-delta
        # downtime difference measurable; pipelined ships keep ticking
        # steps under the sleep, paused ships are pure downtime.
        self.precopy = precopy
        self.dirty_fraction = max(0.0, min(1.0, dirty_fraction))
        self.precopy_interval_ticks = max(1, int(precopy_interval_ticks))
        self.ship_bps = float(ship_bps)
        if precopy and state_bytes <= 0:
            state_bytes = 1 << 20
        self._state = bytearray(state_bytes)
        self._delta = None
        if state_bytes > 0:
            from ..workloads.checkpointing import DeltaCheckpointer

            self._delta = DeltaCheckpointer(ckpt_dir, block_size=4096)
        self.step = 0
        self.saved_step: Optional[int] = None
        self.resumed_step: Optional[int] = None
        self.last_signal = None
        # Measured by whichever checkpoint path ran on the drain: how
        # long training was PAUSED shipping state (the downtime the
        # bench compares full-checkpoint vs pre-copy cutover on).
        self.pause_ms: Optional[float] = None
        self.precopy_rounds = 0
        self.final_delta_bytes: Optional[int] = None
        self.full_bytes: Optional[int] = None
        self.final_chain: str = ""
        self.exited = threading.Event()
        self.watcher = LifecycleWatcher(
            alloc_spec_dir, alloc_hash, poll_interval_s=0.0
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"sim-workload-{alloc_hash[:8]}",
        )

    def start(self) -> "SimWorkload":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)

    def _save(self) -> None:
        import json as _json

        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(os.path.join(self.ckpt_dir, "state.json"), "w") as f:
            _json.dump({"step": self.step}, f)
        self.saved_step = self.step

    def _mutate(self) -> None:
        """Dirty a deterministic, step-dependent subset of state blocks
        — the working set a pre-copy round has to re-ship."""
        if not self._state:
            return
        bs = 4096
        n_blocks = max(1, len(self._state) // bs)
        dirty = max(1, int(n_blocks * self.dirty_fraction))
        stamp = (self.step & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
        for i in range(dirty):
            off = ((self.step * 31 + i * 7) % n_blocks) * bs
            self._state[off:off + 8] = stamp

    def _ship(self, n_bytes, pause: bool) -> None:
        """Model shipping ``n_bytes`` to shared storage at ship_bps.
        ``pause=True`` stops training for the duration (downtime);
        ``pause=False`` pipelines — steps keep ticking under the
        transfer, which is the whole point of pre-copy."""
        if self.ship_bps <= 0.0 or not n_bytes:
            return
        end = time.monotonic() + float(n_bytes) / self.ship_bps
        while not self._stop.is_set():
            left = end - time.monotonic()
            if left <= 0:
                return
            if pause:
                time.sleep(min(0.005, left))
            else:
                self.step += 1
                self._mutate()
                self._stop.wait(min(self.tick_s, left))

    def _precopy_drain(self, sig) -> None:
        """The pre-copy half of the lifecycle contract: stream delta
        rounds (kind="precopy" acks) while training continues, pause at
        the coordinator's cutover signal, ship ONLY the final delta,
        then write the ordinary cutover ack the early-reclaim pass
        completes the drain on."""
        from ..workloads.lifecycle import SIGNAL_CUTOVER

        os.makedirs(self.ckpt_dir, exist_ok=True)
        round_ = 0
        cut = None
        while not self._stop.is_set() and cut is None:
            summary = self._delta.save(
                self.step, bytes(self._state), round_=round_
            )
            self._ship(summary["delta_bytes"], pause=False)
            self.watcher.ack_precopy(
                summary["step"], round_, checkpoint_dir=self.ckpt_dir,
                delta_bytes=summary["delta_bytes"],
                total_bytes=summary["total_bytes"],
                digest=summary["chain"], signal=sig.value,
            )
            self.precopy_rounds = round_ + 1
            round_ += 1
            for _ in range(self.precopy_interval_ticks):
                if self._stop.is_set():
                    break
                self.step += 1
                self._mutate()
                got = self.watcher.poll(force=True)
                if got is not None and got.kind == SIGNAL_CUTOVER:
                    cut = got
                    break
                self._stop.wait(self.tick_s)
        # Cutover: training PAUSES here; everything below is downtime.
        t0 = time.monotonic()
        summary = self._delta.save(
            self.step, bytes(self._state), round_=round_
        )
        self._ship(summary["delta_bytes"], pause=True)
        self._save()
        self.pause_ms = (time.monotonic() - t0) * 1000.0
        self.precopy_rounds = round_ + 1
        self.final_delta_bytes = summary["delta_bytes"]
        self.full_bytes = summary["total_bytes"]
        self.final_chain = summary["chain"]
        self.watcher.ack(
            self.step, checkpoint_dir=self.ckpt_dir,
            signal=sig.value, epoch=sig.epoch, digest=summary["chain"],
            extra={
                "precopy_rounds": round_,
                "delta_bytes": summary["delta_bytes"],
                "full_bytes": summary["total_bytes"],
                "cutover_ms": round(self.pause_ms, 3),
            },
        )

    def _maybe_resume(self) -> None:
        import json as _json

        deadline = time.monotonic() + self.resume_wait_s
        while not self._stop.is_set():
            req = self.watcher.restore_request()
            if req:
                step = None
                if self._delta is not None:
                    # a pre-copy source left a delta chain: reassemble
                    # (and implicitly verify digests) before trusting it
                    try:
                        from ..workloads.checkpointing import (
                            DeltaCheckpointer,
                        )

                        payload, manifest = DeltaCheckpointer(
                            req["checkpoint_dir"], block_size=4096
                        ).load()
                        self._state = bytearray(payload)
                        step = int(manifest["step"])
                    except (ValueError, OSError, KeyError, TypeError):
                        step = None
                if step is None:
                    try:
                        with open(os.path.join(
                            req["checkpoint_dir"], "state.json"
                        )) as f:
                            step = int(_json.load(f)["step"])
                    except (OSError, ValueError, KeyError, TypeError):
                        step = int(req.get("step") or 0)
                self.step = step
                self.resumed_step = self.step
                self.watcher.ack_resume(
                    self.step, checkpoint_dir=req["checkpoint_dir"]
                )
                return
            if time.monotonic() >= deadline:
                return
            time.sleep(0.02)

    def _run(self) -> None:
        from ..workloads.lifecycle import SIGNAL_DRAIN

        # The destination agent stamps the restore env moments AFTER
        # the replacement's bind; a migrating workload polls briefly
        # before concluding it starts from scratch.
        self._maybe_resume()
        while not self._stop.is_set():
            self.step += 1
            if self._state:
                self._mutate()
            sig = self.watcher.poll(force=True)
            if sig is not None:
                self.last_signal = sig
                if self.precopy and sig.kind == SIGNAL_DRAIN:
                    self._precopy_drain(sig)
                    if self.exit_on_drain:
                        break
                    self._stop.wait(self.tick_s)
                    continue
                t0 = time.monotonic()
                self._save()
                if self._state and self._delta is not None:
                    # full-checkpoint baseline: the WHOLE state ships
                    # inside the pause window
                    summary = self._delta.save(
                        self.step, bytes(self._state), round_=0
                    )
                    self._ship(summary["total_bytes"], pause=True)
                    self.full_bytes = summary["total_bytes"]
                    self.final_chain = summary["chain"]
                if sig.kind == SIGNAL_DRAIN:
                    self.pause_ms = (time.monotonic() - t0) * 1000.0
                self.watcher.ack(
                    self.step, checkpoint_dir=self.ckpt_dir,
                    signal=sig.value, epoch=sig.epoch,
                )
                if sig.kind == SIGNAL_DRAIN and self.exit_on_drain:
                    break
            self._stop.wait(self.tick_s)
        self.exited.set()


class FleetSim:
    """Build, drive and tear down an N-node simulated fleet.

    ``base_dir`` must be SHORT (AF_UNIX socket paths cap at ~107 chars;
    each node's kubelet sockets live under ``base_dir/n<i>/``).
    """

    def __init__(
        self,
        base_dir: str,
        nodes: int = 8,
        operator_kind: str = "stub:4",
        reconcile_period_s: float = 2.0,
        dp_pool_size: int = 4,
        enable_sampler: bool = False,
        core_units_per_pod: int = 10,
        slice_membership_ttl_s: float = 1.0,
        operator_kinds: Optional[List[str]] = None,
        drain_deadline_s: float = 5.0,
        preemption_notice_s: Optional[float] = None,
        drain_period_s: float = 0.5,
        migration_period_s: float = 0.25,
        timeline_cap: Optional[int] = None,
        storage_batch_window_s: float = 0.0,
        sink_flush_window_s: float = 0.0,
        goodput_period_s: float = 1.0,
        sampler_period_s: float = 10.0,
        repartition_period_s: float = 10.0,
        slow_span_ms: Optional[float] = None,
        profile_hz: float = 0.0,
        enable_events: bool = True,
        event_safety_net_factor: float = 1.0,
    ) -> None:
        self.base_dir = base_dir
        self.n_nodes = nodes
        self.operator_kind = operator_kind
        # Heterogeneous fleet: one operator kind PER NODE, cycling
        # through the list — e.g. ["nvidia", "stub:8", "stub:4"] puts the
        # host's cards under node 0 and stub nodes of 8 and 4 cards
        # after it.
        self.operator_kinds = list(operator_kinds or [])
        self.reconcile_period_s = reconcile_period_s
        self.dp_pool_size = dp_pool_size
        self.enable_sampler = enable_sampler
        self.core_units_per_pod = core_units_per_pod
        # Short TTL: a chaos scenario expects reform within a few
        # reconcile periods, not after a production-sized cache window.
        self.slice_membership_ttl_s = slice_membership_ttl_s
        # Drain lifecycle pacing: sim deadlines are seconds, not the
        # production 300s — chaos scenarios assert reclaim-on-deadline.
        self.drain_deadline_s = drain_deadline_s
        # Preemption-notice clamp (drain.py): None = the production
        # default; sim deadlines are already shorter than the default
        # notice, so only clamp-specific scenarios set this.
        self.preemption_notice_s = preemption_notice_s
        self.drain_period_s = drain_period_s
        # Migration-coordinator tick (migration.py): sim scenarios
        # assert ack-to-early-reclaim latency in fractions of the
        # already-short sim drain deadline.
        self.migration_period_s = migration_period_s
        # Lifecycle-timeline ring cap override (timeline.py): the
        # timeline smoke shrinks it to prove the ring + eviction
        # counter under churn; None = the production default.
        self.timeline_cap = timeline_cap
        # Scale-harness batching knobs: group-commit storage
        # writes (storage/batcher.py) and coalesced sink traffic
        # (async_sink flush window). 0/0 = the historical per-write
        # shape — the scale leg's unbatched baseline.
        self.storage_batch_window_s = storage_batch_window_s
        self.sink_flush_window_s = sink_flush_window_s
        # Goodput-ledger replay period (goodput.py): sim scenarios read
        # downtime attribution within seconds of the transitions, not
        # after a production-paced 10s tick.
        self.goodput_period_s = goodput_period_s
        # Sampler/repartition pacing: scenarios that drive the usage ->
        # quota loop by hand park both supervised loops (3600.0) so a
        # background tick can't race their round-paced assertions.
        self.sampler_period_s = sampler_period_s
        self.repartition_period_s = repartition_period_s
        # Latency observatory knobs (latency.py / profiler.py): the
        # latency smoke lowers the slow-span threshold to exercise the
        # slow_span journal path and turns the self-profiler on to pin
        # its measured overhead.
        self.slow_span_ms = slow_span_ms
        self.profile_hz = profile_hz
        # Event-driven core (events.py): enable_events=False is the
        # poll-only fallback A/B baseline. The safety-net factor
        # defaults to 1.0 IN THE SIM (production default is 10x):
        # existing scenarios time their assertions against the base
        # periods, and a stretched sweep must be opted into by the
        # scenarios that prove the stretch.
        self.enable_events = enable_events
        self.event_safety_net_factor = event_safety_net_factor
        self.nodes: List[SimNode] = []
        self.apiserver = None
        self.api_url = ""
        self._prev_tracer = None
        self._started = False

    # -- lifecycle ------------------------------------------------------------

    def start(self, trace_capacity: Optional[int] = None) -> None:
        FakeAPIServer, FakeKubelet, _ = _import_fakes()
        from prometheus_client import CollectorRegistry

        from ..metrics import AgentMetrics

        # One ring serves all in-process agents; churning thousands of
        # binds through the default 256-slot ring would evict the very
        # traces the continuity check follows. Swapped back at stop().
        if trace_capacity is None:
            trace_capacity = max(1024, 4 * self.n_nodes * 256)
        self._prev_tracer = set_tracer(Tracer(capacity=trace_capacity))

        self.apiserver = FakeAPIServer()
        self.api_url = self.apiserver.start()
        try:
            self._start_nodes(FakeKubelet, AgentMetrics, CollectorRegistry)
        except BaseException:
            # A node that failed to come up must not leak the ones that
            # did (or the swapped global tracer) into the caller's test.
            self.stop()
            raise
        self._started = True

    def _start_nodes(
        self, FakeKubelet, AgentMetrics, CollectorRegistry
    ) -> None:
        for i in range(self.n_nodes):
            node = SimNode(f"sim-{i}", os.path.join(self.base_dir, f"n{i}"))
            os.makedirs(os.path.join(node.root, "dev"), exist_ok=True)
            node.kubelet = FakeKubelet(
                os.path.join(node.root, "dp"),
                os.path.join(node.root, "pr", "kubelet.sock"),
            )
            node.kubelet.start()
            node.metrics = AgentMetrics(registry=CollectorRegistry())
            httpd = node.metrics.serve(0)  # ephemeral loopback port
            node.metrics_url = f"http://127.0.0.1:{httpd.server_address[1]}"
            node.operator_kind = (
                self.operator_kinds[i % len(self.operator_kinds)]
                if self.operator_kinds else self.operator_kind
            )
            node.opts = ManagerOptions(
                node_name=node.name,
                operator=self._operator_for(node),
                db_path=os.path.join(node.root, "meta.db"),
                operator_kind=node.operator_kind,
                dev_root=os.path.join(node.root, "dev"),
                device_plugin_dir=os.path.join(node.root, "dp"),
                pod_resources_socket=os.path.join(
                    node.root, "pr", "kubelet.sock"
                ),
                alloc_spec_dir=os.path.join(node.root, "alloc"),
                kube_client=KubeClient(self.api_url),
                metrics=node.metrics,
                dp_pool_size=self.dp_pool_size,
                enable_sampler=self.enable_sampler,
                reconcile_period_s=self.reconcile_period_s,
                slice_membership_ttl_s=self.slice_membership_ttl_s,
                drain_deadline_s=self.drain_deadline_s,
                drain_period_s=self.drain_period_s,
                **(
                    {"preemption_notice_s": self.preemption_notice_s}
                    if self.preemption_notice_s is not None else {}
                ),
                migration_period_s=self.migration_period_s,
                storage_batch_window_s=self.storage_batch_window_s,
                sink_flush_window_s=self.sink_flush_window_s,
                goodput_period_s=self.goodput_period_s,
                sampler_period_s=self.sampler_period_s,
                repartition_period_s=self.repartition_period_s,
                slow_span_ms=self.slow_span_ms,
                profile_hz=self.profile_hz,
                enable_event_bus=self.enable_events,
                event_safety_net_factor=self.event_safety_net_factor,
                **(
                    {"timeline_cap": self.timeline_cap}
                    if self.timeline_cap is not None else {}
                ),
            )
            node.manager = NodeManager(node.opts)
            node.manager.run(block=False)
            self.nodes.append(node)  # appended first: stop() reaps it
            if not node.kubelet.wait_registrations(2, timeout=20):
                raise RuntimeError(
                    f"{node.name}: agent failed to register with its "
                    "fake kubelet"
                )

    def _operator_for(self, node: SimNode):
        """The operator object ``node``'s manager takes (called once a
        node, at start); None, here, builds it from
        ``node.operator_kind`` under ``node.root/dev``. A subclass returns
        one of its own, e.g. the host's cards behind an NvidiaOperator
        whose maintenance and preemption fetchers it answers."""
        return None

    def stop(self) -> None:
        for node in self.nodes:
            try:
                node.manager.stop()
            except Exception:  # noqa: BLE001 - teardown keeps going
                pass
            try:
                node.metrics.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                node.kubelet.stop()
            except Exception:  # noqa: BLE001
                pass
        self.nodes = []
        if self.apiserver is not None:
            self.apiserver.stop()
            self.apiserver = None
        if self._prev_tracer is not None:
            set_tracer(self._prev_tracer)
            self._prev_tracer = None
        self._started = False

    def targets(self) -> Dict[str, str]:
        """node name -> metrics base URL (the aggregator's scrape list);
        killed nodes drop out, exactly as they would from a production
        scrape discovery."""
        return {
            node.name: node.metrics_url
            for node in self.nodes if not node.dead
        }

    # -- chaos: kill one agent ------------------------------------------------

    def kill_node(self, idx: int) -> SimNode:
        """Take one node down hard: agent stopped, kubelet gone, metrics
        endpoint dark. The node's PODS stay at the apiserver until the
        caller deletes them (in production that is the node controller's
        eviction, not the dead agent's doing) — slice chaos scenarios
        delete the member pod to model the eviction."""
        node = self.nodes[idx]
        node.dead = True
        for closer in (
            lambda: node.manager.stop(),
            lambda: node.metrics.close(),
            lambda: node.kubelet.stop(),
        ):
            try:
                closer()
            except Exception:  # noqa: BLE001 - a kill is best-effort
                pass
        return node

    # -- chaos: drain lifecycle (drain.py) ------------------------------------

    def trigger_maintenance(
        self, idx: int, event: str = "TERMINATE_ON_HOST_MAINTENANCE"
    ) -> None:
        """Announce a maintenance event on one node's operator;
        the node's drain orchestrator picks it up on its next poll."""
        self.nodes[idx].manager.operator.set_maintenance_event(event)

    def clear_maintenance(self, idx: int) -> None:
        self.nodes[idx].manager.operator.set_maintenance_event("NONE")

    def trigger_preemption(self, idx: int) -> None:
        """Spot-preemption notice: never un-rings (like real GCE)."""
        self.nodes[idx].manager.operator.set_preempted(True)

    def drain_status(self, idx: int) -> Dict:
        return self.nodes[idx].manager.drain.status()

    def wait_drain_state(
        self, idx: int, states, timeout_s: float = 30.0
    ) -> str:
        """Block until node ``idx``'s drain lifecycle reaches one of
        ``states``; returns the state reached."""
        states = {states} if isinstance(states, str) else set(states)
        deadline = time.monotonic() + timeout_s
        while True:
            state = self.nodes[idx].manager.drain.state
            if state in states:
                return state
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{self.nodes[idx].name}: drain state {state!r} never "
                    f"reached {sorted(states)} "
                    f"(status: {self.drain_status(idx)})"
                )
            time.sleep(0.02)

    def restart_node(self, idx: int) -> SimNode:
        """Kill and re-boot one node's AGENT over its surviving
        db/kubelet/disk — the mid-drain restart scenario: the new manager
        must resume the journaled drain lifecycle (cordon, deadline,
        replay suppression) before its boot reconcile runs."""
        node = self.nodes[idx]
        old_op = node.manager.operator
        # The stub operator is process memory; the real metadata server
        # would still be announcing the event to the restarted agent, so
        # carry any injected maintenance/preemption state across.
        maint = (
            old_op.maintenance_event()
            if hasattr(old_op, "maintenance_event") else None
        )
        preempted = old_op.preempted() if hasattr(old_op, "preempted") else False
        try:
            node.manager.stop()
        except Exception:  # noqa: BLE001 - a crash is allowed to be messy
            pass
        prior = len(node.kubelet.registrations)  # count is cumulative
        node.manager = NodeManager(node.opts)
        new_op = node.manager.operator
        if maint and hasattr(new_op, "set_maintenance_event"):
            new_op.set_maintenance_event(maint)
        if preempted and hasattr(new_op, "set_preempted"):
            new_op.set_preempted(True)
        node.manager.run(block=False)
        if not node.kubelet.wait_registrations(prior + 2, timeout=20):
            raise RuntimeError(
                f"{node.name}: restarted agent failed to re-register"
            )
        return node

    # -- admission (the scheduler's half) -------------------------------------

    def chip_indexes(self, node: SimNode) -> List[int]:
        """The node's card indexes, ascending: 0..n-1 on a stub node, the
        cards' minors on a node of real cards (an NvidiaOperator's index
        is the node minor)."""
        return sorted(d.index for d in node.manager.operator.devices())

    def admit_pods(
        self,
        pods_per_node: int,
        namespace: str = "fleet",
        node_idxs: Optional[List[int]] = None,
    ) -> List[PodRef]:
        """Schedule pods round-robin over each node's cards, stamping the
        elastic-scheduler annotations plus an admission trace id.
        ``node_idxs`` restricts admission to the named nodes (default:
        all) — e.g. a churn burst aimed at one node's journal."""
        _, _, make_pod = _import_fakes()
        refs: List[PodRef] = []
        for i in (
            range(self.n_nodes) if node_idxs is None else node_idxs
        ):
            node = self.nodes[i]
            chips = self.chip_indexes(node)
            for j in range(pods_per_node):
                ref = PodRef(
                    i, namespace, f"p{i}-{j}", chips[j % len(chips)],
                    new_trace_id(),
                )
                self.apiserver.upsert_pod(make_pod(
                    ref.namespace, ref.name, node.name,
                    annotations={
                        AnnotationAssumed: "true",
                        container_annotation(CONTAINER): str(ref.chip),
                        AnnotationTraceID: ref.trace_id,
                    },
                    containers=[{"name": CONTAINER}],
                ))
                refs.append(ref)
        return refs

    def admit_pod(
        self,
        namespace: str,
        name: str,
        node_idx: int,
        chip: int = 0,
        annotations: Optional[Dict[str, str]] = None,
    ) -> PodRef:
        """Admit ONE pod with an explicit identity — the migration
        scenarios' replacement admission: the external scheduler lands
        the workload's next generation (same ns/name) on whatever node
        has room, and that node's agent finds the MigrationRecord."""
        _, _, make_pod = _import_fakes()
        node = self.nodes[node_idx]
        ref = PodRef(node_idx, namespace, name, chip, new_trace_id())
        ann = {
            AnnotationAssumed: "true",
            container_annotation(CONTAINER): str(chip),
            AnnotationTraceID: ref.trace_id,
        }
        ann.update(annotations or {})
        self.apiserver.upsert_pod(make_pod(
            ref.namespace, ref.name, node.name,
            annotations=ann, containers=[{"name": CONTAINER}],
        ))
        return ref

    # -- migration handshake (migration.py) -----------------------------------

    def alloc_hash_of(self, ref: PodRef) -> str:
        """The pod's allocation hash — the key its ack file is written
        under ('' when unbound). In a real container this is the
        agent-injected ``TPU`` (or ``GPU``) env; the sim reads the bound
        record."""
        info = self.nodes[ref.node_idx].storage.load(
            ref.namespace, ref.name
        )
        if info is None:
            return ""
        for rec in info.records():
            return rec.device.hash
        return ""

    def start_workload(
        self,
        ref: PodRef,
        ckpt_dir: str,
        tick_s: float = 0.02,
        resume_wait_s: float = 0.0,
        exit_on_drain: bool = True,
        precopy: bool = False,
        state_bytes: int = 0,
        dirty_fraction: float = 0.05,
        precopy_interval_ticks: int = 2,
        ship_bps: float = 0.0,
    ) -> SimWorkload:
        """Run a stub workload (REAL LifecycleWatcher) inside ``ref``'s
        binding; the pod must be bound first (the hash comes from its
        stamped spec)."""
        alloc_hash = self.alloc_hash_of(ref)
        if not alloc_hash:
            raise RuntimeError(f"{ref.pod_key} is not bound (no alloc hash)")
        return SimWorkload(
            self.nodes[ref.node_idx].opts.alloc_spec_dir, alloc_hash,
            ckpt_dir, tick_s=tick_s, resume_wait_s=resume_wait_s,
            exit_on_drain=exit_on_drain, precopy=precopy,
            state_bytes=state_bytes, dirty_fraction=dirty_fraction,
            precopy_interval_ticks=precopy_interval_ticks,
            ship_bps=ship_bps,
        ).start()

    def migration_status(self, idx: int) -> Dict:
        return self.nodes[idx].manager.migration.status()

    def wait_migration_completed(
        self, idx: int, pod_key: str, timeout_s: float = 30.0
    ) -> Dict:
        """Block until node ``idx``'s coordinator VERIFIES the inbound
        resume of ``pod_key``; returns the completion entry."""
        deadline = time.monotonic() + timeout_s
        while True:
            status = self.migration_status(idx)
            for c in status.get("recent_completions", []):
                if c.get("pod") == pod_key:
                    return c
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{self.nodes[idx].name}: migration of {pod_key} "
                    f"never verified (status: {status})"
                )
            time.sleep(0.02)

    # -- goodput ledger (goodput.py) ------------------------------------------

    def tick_goodput(self) -> None:
        """Force one ledger replay on every live node so the NEXT
        /debug/goodput (and the aggregator's fleet_goodput) reads the
        journal as of now — deterministic scenarios must not wait out
        the supervised loop's period."""
        for node in self.nodes:
            if not node.dead:
                node.manager.goodput.tick()

    def goodput_status(self, idx: int, **kwargs) -> Dict:
        return self.nodes[idx].manager.goodput.status(**kwargs)

    def wait_synced(self, refs: List[PodRef], timeout_s: float = 60.0) -> None:
        """Wait until every node's sitter has seen its LAST admitted pod
        (watch events are ordered per node, so the last one suffices)."""
        last_by_node: Dict[int, PodRef] = {}
        for ref in refs:
            last_by_node[ref.node_idx] = ref
        deadline = time.monotonic() + timeout_s
        for i, ref in last_by_node.items():
            sitter = self.nodes[i].manager.sitter
            while sitter.get_pod(ref.namespace, ref.name) is None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{self.nodes[i].name}: sitter never saw "
                        f"{ref.pod_key}"
                    )
                time.sleep(0.005)

    # -- the bind drive (kubelet's half) --------------------------------------

    def _core_ids(self, ref: PodRef) -> List[str]:
        # The unit field of a fake id is never parsed (only the chip
        # is), so embedding the pod KEY makes every pod's id set
        # pairwise distinct on its node without unit-space bookkeeping.
        # The namespace must be in there too: a real kubelet never
        # assigns one device id to two live pods, and scenario phases
        # reuse pod names across namespaces (admission waves, churn
        # replacements) — name-only ids would alias their device-set
        # hashes and make the locator's hash->owner mapping ambiguous.
        from ..plugins.gpushare import core_device_id

        return [
            core_device_id(ref.chip, f"{ref.namespace}.{ref.name}u{j}")
            for j in range(self.core_units_per_pod)
        ]

    def bind_pod(self, ref: PodRef) -> None:
        """One kubelet-shaped bind on the pod's node: Allocate, record
        the assignment in pod-resources, PreStartContainer — servicers
        invoked in-process, Lists/sinks over real transports."""
        node = self.nodes[ref.node_idx]
        core = node.manager.plugin.core
        ids = self._core_ids(ref)
        core.Allocate(dp.AllocateRequest(container_requests=[
            dp.ContainerAllocateRequest(devicesIDs=ids)
        ]), None)
        node.kubelet.assign(
            ref.namespace, ref.name, CONTAINER, ResourceGPUCore, ids
        )
        core.PreStartContainer(
            dp.PreStartContainerRequest(devicesIDs=ids), None
        )

    def churn(
        self,
        refs: List[PodRef],
        workers_per_node: int = 2,
        timeout_s: float = 600.0,
    ) -> dict:
        """Bind every admitted pod, ``workers_per_node`` concurrent
        binders per node across the whole fleet at once; returns driver-
        side latency/throughput stats plus ``churn_end_ts`` (the anchor
        for reconcile-convergence measurement)."""
        by_node: Dict[int, List[PodRef]] = {}
        for ref in refs:
            by_node.setdefault(ref.node_idx, []).append(ref)
        bind_ms: List[Optional[float]] = [None] * len(refs)
        index_of = {id(ref): i for i, ref in enumerate(refs)}
        errors: List[str] = []
        err_lock = threading.Lock()
        n_workers = sum(
            min(workers_per_node, len(v)) for v in by_node.values()
        )
        barrier = threading.Barrier(n_workers + 1)

        def worker(chunk: List[PodRef]) -> None:
            barrier.wait()
            for ref in chunk:
                try:
                    t0 = time.perf_counter()
                    self.bind_pod(ref)
                    bind_ms[index_of[id(ref)]] = (
                        time.perf_counter() - t0
                    ) * 1000
                except Exception as e:  # noqa: BLE001 - collected, not fatal
                    with err_lock:
                        errors.append(
                            f"{ref.pod_key}: {type(e).__name__}: {e}"
                        )

        threads = []
        for node_refs in by_node.values():
            w = min(workers_per_node, len(node_refs))
            for k in range(w):
                threads.append(threading.Thread(
                    target=worker, args=(node_refs[k::w],), daemon=True,
                ))
        for t in threads:
            t.start()
        barrier.wait()
        wall_t0 = time.perf_counter()
        # One shared deadline, not one per join: 16 wedged workers must
        # not stack 16 timeouts. Workers still alive afterwards are
        # REPORTED (timed_out_workers) — the numbers below would
        # otherwise read as a healthy-but-slow fleet while daemon
        # threads keep mutating the stores under the caller's reads.
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        timed_out = sum(1 for t in threads if t.is_alive())
        wall_s = time.perf_counter() - wall_t0
        done = sorted(v for v in bind_ms if v is not None)
        return {
            "pods": len(refs),
            "bound": len(done),
            "errors": errors[:5],
            "error_count": len(errors),
            "workers": n_workers,
            "timed_out_workers": timed_out,
            "bind_p50_ms": statistics.median(done) if done else None,
            "bind_p99_ms": (
                done[max(0, int(len(done) * 0.99) - 1)] if done else None
            ),
            "binds_per_s": len(done) / wall_s if wall_s > 0 else None,
            "wall_s": wall_s,
            "churn_end_ts": time.time(),
        }

    # -- pod deletion (steady-state churn: the scheduler's other half) --------

    def delete_pods(self, refs: List[PodRef]) -> None:
        """Delete admitted pods the way the control plane would: gone
        from the apiserver (the sitter's DELETED event feeds each
        node's GC) and unassigned at the node's kubelet (so the
        reconciler doesn't replay the bind back)."""
        for ref in refs:
            self.nodes[ref.node_idx].kubelet.unassign_pod(
                ref.namespace, ref.name
            )
            self.apiserver.delete_pod(ref.namespace, ref.name)

    def wait_reclaimed(
        self, refs: List[PodRef], timeout_s: float = 60.0
    ) -> float:
        """Block until every deleted pod's checkpoint record is gone
        (GC/reconciler reclaimed the binding); returns the wait."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        for ref in refs:
            node = self.nodes[ref.node_idx]
            if node.dead:
                continue
            while node.storage.load(ref.namespace, ref.name) is not None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{node.name}: {ref.pod_key} never reclaimed "
                        "after delete"
                    )
                time.sleep(0.02)
        return time.monotonic() - t0

    # -- fleet-side ground truth (assertions, not metrics) --------------------

    def stored_binds(self) -> Dict[str, int]:
        """Per-node checkpoint-store record counts (the 'every bind
        landed' ground truth the smoke asserts against)."""
        return {
            node.name: node.storage.count()
            for node in self.nodes if not node.dead
        }

    # -- multi-host slices (slices/) ------------------------------------------

    def admit_slice(
        self,
        slice_id: str,
        node_idxs: List[int],
        accelerator_type: str = "h100-sxm5-32",
        namespace: str = "slice",
    ) -> List[PodRef]:
        """Admit one slice-member pod per named node, carrying the full
        slice contract: identity, shape, index-ordered host list and
        this member's worker id — what the elastic scheduler would
        stamp."""
        _, _, make_pod = _import_fakes()
        hosts = ",".join(self.nodes[i].name for i in node_idxs)
        refs: List[PodRef] = []
        for w, i in enumerate(node_idxs):
            node = self.nodes[i]
            # the node's first card (0 on a stub node)
            chip = self.chip_indexes(node)[0]
            ref = PodRef(
                i, namespace, f"m{w}-{slice_id}", chip, new_trace_id()
            )
            self.apiserver.upsert_pod(make_pod(
                ref.namespace, ref.name, node.name,
                annotations={
                    AnnotationAssumed: "true",
                    container_annotation(CONTAINER): str(chip),
                    AnnotationTraceID: ref.trace_id,
                    AnnotationSliceID: slice_id,
                    AnnotationSliceName: accelerator_type,
                    AnnotationSliceWorkerID: str(w),
                    AnnotationSliceWorkerHosts: hosts,
                },
                containers=[{"name": CONTAINER}],
            ))
            refs.append(ref)
        return refs

    def slice_env_of(self, ref: PodRef) -> Dict[str, str]:
        """The env stamped into ``ref``'s on-disk alloc spec (empty when
        unbound) — the ground truth slice assertions read."""
        node = self.nodes[ref.node_idx]
        info = node.storage.load(ref.namespace, ref.name)
        if info is None:
            return {}
        core = node.manager.plugin.core
        for by_resource in info.allocations.values():
            for rec in by_resource.values():
                spec = core.read_alloc_spec(rec.device.hash)
                if spec and spec.get("env"):
                    return dict(spec["env"])
        return {}

    def wait_slice_reformed(
        self,
        refs: List[PodRef],
        expected_hosts: List[str],
        expected_epoch: int,
        timeout_s: float = 60.0,
    ) -> float:
        """Block until every surviving member's stamped env shows the
        expected host list AND epoch; returns the wait in seconds."""
        want_hosts = ",".join(expected_hosts)
        want_epoch = str(expected_epoch)
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        for ref in refs:
            if self.nodes[ref.node_idx].dead:
                continue
            while True:
                env = self.slice_env_of(ref)
                if (
                    env.get("TPU_WORKER_HOSTNAMES") == want_hosts
                    and env.get(EnvSliceEpoch) == want_epoch
                ):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{ref.pod_key} never re-formed to "
                        f"[{want_hosts}] epoch {want_epoch}; env now: "
                        f"{ {k: v for k, v in env.items() if k.startswith(('TPU_', 'ELASTIC_TPU_SLICE'))} }"
                    )
                time.sleep(0.02)
        return time.monotonic() - t0
