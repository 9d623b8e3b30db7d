"""A node for holding the port's agent side against the agent's: a fake
kubelet (``tests/fake_kubelet.py``, real gRPC), a fake sitter, a temp dev
root and alloc dir, and generations of storage, operator, pod-resources
client, locators, plugin bundle and reconciler over them, built from the
port's modules or the agent's. Both sides get the port's 4-card
``StubOperator`` with minors permuted against the indexes, as
``test_torch_gpushare.py`` does, so that links and device paths agree.

``boot(**obs)`` wires a generation's observability plane too, each part
of the side's own package: ``bus`` (an EventBus), ``metrics`` (an
AgentMetrics), ``timeline=True`` (a Timeline over the generation's store,
on ``clock``), ``events`` and ``crd_recorder`` (recorders),
``lag_tracker`` (the port's only: the agent's plugins take none) and
``batch_window_s`` (the store's group-commit window).

``to_agent`` maps the port's names onto the agent's (``gpu-`` ids and
resources, their hashes) and sets aside what differs by design: the
visibility env and the port's ``control_paths``. Trace ids are random per
bind: each must be 16 hex digits, and compares as a placeholder.

``Handshake`` puts a generation's drain orchestrator, migration
coordinator and utilization sampler over it, each from the side's own
package, on the side's ``ManualClock``, with an Event recorder that keeps
(object, reason), an AgentMetrics on its own registry and a KubeClient of
a ``tests/fake_apiserver.py``; ``snapshot()`` reads what the three show.
Tests drive ``tick()`` and ``sample_once()`` by hand: no sleeps, no
threads.

``RepartitionSide`` adds the side's repartition controller (wired as the
manager wires it) over pods d, b, o and l sharing card 0, each opted in;
``cycle(reports)`` writes usage reports, advances the clock a second,
samples and ticks the controller.
"""

import json
import os
import re
import shutil
import tempfile
import threading

from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from elastic_tpu_agent import common as agent_common
from elastic_tpu_agent import drain as agent_drain
from elastic_tpu_agent import faults as agent_faults
from elastic_tpu_agent import metrics as agent_metrics
from elastic_tpu_agent import migration as agent_migration
from elastic_tpu_agent import rpc as agent_rpc
from elastic_tpu_agent import reconciler as agent_reconciler
from elastic_tpu_agent import repartition as agent_repartition
from elastic_tpu_agent import sampler as agent_sampler
from elastic_tpu_agent import timeline as agent_timeline
from elastic_tpu_agent import tracing as agent_tracing
from elastic_tpu_agent.kube.client import KubeClient as AgentKube
from elastic_tpu_agent.kube import locator as agent_locator
from elastic_tpu_agent.plugins import tpushare
from elastic_tpu_agent.plugins.base import PluginConfig as AgentConfig
from elastic_tpu_agent.storage import Storage as AgentStorage
from elastic_tpu_agent.types import Device as AgentDevice
from elastic_tpu_agent_torch import common as port_common
from elastic_tpu_agent_torch import (
    drain, faults, metrics, migration, reconciler, repartition, rpc,
)
from elastic_tpu_agent_torch import sampler as sampler_mod
from elastic_tpu_agent_torch import timeline as timeline_mod
from elastic_tpu_agent_torch import tracing
from elastic_tpu_agent_torch.common import (
    AnnotationAssumed,
    AnnotationSliceID,
    BytesPerMemoryUnit,
    ResourceGPUCore,
    ResourceGPUMemory,
    container_annotation,
)
from elastic_tpu_agent_torch.device import StubOperator
from elastic_tpu_agent_torch.device.qos import (
    AnnotationQoSPriority,
    AnnotationRepartition,
)
from elastic_tpu_agent_torch.device.stub import H100_SXM5_HBM_BYTES
from elastic_tpu_agent_torch.kube import locator
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.plugins import gpushare
from elastic_tpu_agent_torch.plugins.base import PluginConfig
from elastic_tpu_agent_torch.storage import Storage
from elastic_tpu_agent_torch.types import Device

from fake_apiserver import FakeAPIServer
from fake_kubelet import FakeKubelet, FakeSitter

MINORS = [2, 0, 3, 1]       # card index -> /dev/nvidia<minor>
UNITS = H100_SXM5_HBM_BYTES // BytesPerMemoryUnit
AGENT_CORE = "elasticgpu.io/tpu-core"
AGENT_MEM = "elasticgpu.io/tpu-memory"
VISIBILITY = {"CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS",
              "TPU_VISIBLE_DEVICES"}
PORT_ONLY = {"control_paths"}
TRACE_KEY = "ELASTIC_TPU_TRACE_ID"
TRACE_ID = re.compile(r"[0-9a-f]{16}")
NAMES = (("elastic-gpushare-", "elastic-tpushare-"), ("gpu-core", "tpu-core"),
         ("gpu-mem", "tpu-mem"))
# report keys of the agent's hooks the port leaves to later slices
AGENT_ONLY_REPORT = ("slice_reforms", "slice_check_errors",
                     "slice_reform_failures")


def to_agent(obj, hashes):
    """``obj`` (JSON-able) with the port's names and hashes mapped to the
    agent's, the visibility keys and ``control_paths`` dropped and trace
    ids made placeholders."""
    text = json.dumps(obj)
    for port_h, agent_h in hashes.items():
        text = text.replace(port_h, agent_h)
    for mine, theirs in NAMES:
        text = text.replace(mine, theirs)
    return normalize(json.loads(text))


def normalize(x):
    if isinstance(x, dict):
        if TRACE_KEY in x:
            assert TRACE_ID.fullmatch(x[TRACE_KEY]), x[TRACE_KEY]
            x = dict(x, **{TRACE_KEY: "<trace>"})
        return {k: normalize(v) for k, v in x.items()
                if k not in VISIBILITY | PORT_ONLY}
    if isinstance(x, list):
        return [normalize(v) for v in x]
    return x


class Node:
    """One node's lasting state (kubelet, sitter, dev root, alloc dir, db
    file) for one side; ``boot()`` builds a generation of the agent over
    it, as a restarted agent process would."""

    def __init__(self, root: str, port: bool) -> None:
        self.port = port
        self.root = root
        self.dev_root = os.path.join(root, "dev")
        self.alloc_dir = os.path.join(root, "alloc")
        os.makedirs(self.dev_root)
        self.db = os.path.join(root, "meta.db")
        self.kubelet = FakeKubelet(os.path.join(root, "dp"),
                                   os.path.join(root, "pr.sock"))
        self.kubelet.start()
        self.sitter = FakeSitter()
        self.gen = None
        self.hashes = {}

    def res(self, kind: str) -> str:
        if kind == "core":
            return ResourceGPUCore if self.port else AGENT_CORE
        return ResourceGPUMemory if self.port else AGENT_MEM

    def ids(self, kind, chip, units):
        fn = {("core", True): gpushare.core_device_id,
              ("mem", True): gpushare.mem_device_id,
              ("core", False): tpushare.core_device_id,
              ("mem", False): tpushare.mem_device_id}[kind, self.port]
        return [fn(chip, u) for u in units]

    def device(self, kind, ids):
        return (Device if self.port else AgentDevice)(ids, self.res(kind))

    def annotate(self, pod, chips, container="main"):
        self.sitter.add_pod("default", pod, {
            AnnotationAssumed: "true", container_annotation(container): chips})

    def boot(self, dry_run=False, **obs):
        """A new generation over the node's state (the previous one's
        store closed first), with the observability parts ``obs`` names
        (module docstring)."""
        if self.gen is not None:
            self.gen.close()
        self.gen = Generation(self, dry_run, **obs)
        return self.gen

    def bind(self, kind, pod, chip, units, container="main"):
        """The kubelet's flow in-process: the assignment recorded, then the
        PreStart bind handler called directly."""
        ids = self.ids(kind, chip, units)
        self.kubelet.assign("default", pod, container, self.res(kind), ids)
        self.gen.plugin_of(kind)._bind(self.device(kind, ids))
        return self.device(kind, ids).hash

    def state(self):
        """Links, spec files, records and open intents, for comparing."""
        links = {n: os.readlink(os.path.join(self.dev_root, n))
                 for n in sorted(os.listdir(self.dev_root))}
        specs = {}
        if os.path.isdir(self.alloc_dir):
            for name in sorted(os.listdir(self.alloc_dir)):
                path = os.path.join(self.alloc_dir, name)
                if os.path.isfile(path):
                    with open(path) as f:
                        specs[name] = json.load(f)
        store = self.gen.storage
        return dict(
            links=links, specs=specs,
            records={k: json.loads(v.to_json()) for k, v in store.items()},
            intents=len(store.open_intents()),
        )

    def close(self):
        if self.gen is not None:
            self.gen.close()
        self.kubelet.stop()


class Generation:
    """One agent process's objects: the port's or the agent's storage,
    pod-resources client and shared snapshot source, locators, plugin
    bundle and reconciler, with a port stub operator."""

    def __init__(self, node: Node, dry_run: bool, bus=None, metrics=None,
                 timeline=False, clock=None, events=None, crd_recorder=None,
                 lag_tracker=None, batch_window_s=0.0) -> None:
        port = node.port
        self.bus = bus
        self.storage = (Storage if port else AgentStorage)(
            node.db, batch_window_s=batch_window_s, bus=bus)
        self.operator = StubOperator(node.dev_root, num_chips=4,
                                     minors=MINORS)
        sock = node.kubelet.pod_resources_socket
        self.pr_client = (rpc if port else agent_rpc).PodResourcesClient(sock)
        loc = locator if port else agent_locator
        self.source = loc.PodResourcesSnapshotSource(
            self.pr_client, metrics=metrics, bus=bus)
        self.timeline = None
        if timeline:
            self.timeline = (timeline_mod if port else agent_timeline
                             ).Timeline(self.storage, node_name="node-a",
                                        metrics=metrics, clock=clock)
        obs = dict(metrics=metrics, events=events, crd_recorder=crd_recorder,
                   timeline=self.timeline)
        wiring = dict(
            device_plugin_dir=node.kubelet.device_plugin_dir,
            operator=self.operator, sitter=node.sitter,
            storage=self.storage,
            locator_factory=lambda res: loc.KubeletDeviceLocator(
                res, source=self.source),
            extra={"alloc_spec_dir": node.alloc_dir},
            **obs,
        )
        if port:
            wiring["lag_tracker"] = lag_tracker
        config = (PluginConfig if port else AgentConfig)(
            node_name="node-a", pod_resources_socket=sock, **wiring)
        self.plugin = (gpushare.GPUSharePlugin if port
                       else tpushare.TPUSharePlugin)(config)
        self.reconciler = (reconciler if port
                           else agent_reconciler).Reconciler(
            storage=self.storage, operator=self.operator,
            plugin=self.plugin, sitter=node.sitter,
            snapshot_source=self.source, alloc_spec_dir=node.alloc_dir,
            dry_run=dry_run, lag_tracker=lag_tracker, bus=bus, **obs)

    def plugin_of(self, kind):
        return self.plugin.core if kind == "core" else self.plugin.memory

    def close(self):
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        self.pr_client.close()
        self.storage.close()


def port_report(agent_report: dict) -> dict:
    """The agent's report as the port's: its left-out hooks' keys must
    read 0 in these scenarios, and are then dropped."""
    for key in AGENT_ONLY_REPORT:
        assert agent_report[key] == 0, (key, agent_report[key])
    return {k: v for k, v in agent_report.items()
            if k not in AGENT_ONLY_REPORT and k != "duration_s"}


# the metric families the handshake and the sampler feed
HANDSHAKE_FAMILIES = ("elastic_tpu_drain", "elastic_tpu_maintenance",
                      "elastic_tpu_migration", "elastic_tpu_workload",
                      "elastic_tpu_overcommit", "elastic_tpu_chip_duty",
                      "elastic_tpu_chip_hbm", "elastic_tpu_pod_core")
# timeline kinds the handshake writes
HANDSHAKE_KINDS = ("drain_transition", "migration", "cordon")


def clock_of(port: bool):
    """A side's ManualClock at its fixed fake start (equal on both)."""
    return (port_common if port else agent_common).ManualClock()


class Events:
    """An Event recorder keeping the (object, reason) of every Event."""

    def __init__(self) -> None:
        self.posted = []

    def node_event(self, reason, message, type_="Normal", **kw):
        self.posted.append(("node", reason))

    def pod_event(self, namespace, name, reason, message, type_="Normal",
                  **kw):
        self.posted.append((f"{namespace}/{name}", reason))


class Handshake:
    """One generation's drain orchestrator, migration coordinator and
    sampler, from the side's package (module docstring). The generation
    must have been booted with ``timeline=True`` on ``clock``."""

    def __init__(self, node: Node, api_url: str, clock,
                 deadline_s: float = 300.0, notice_s: float = 30.0) -> None:
        port = node.port
        gen = node.gen
        self.node, self.gen, self.clock = node, gen, clock
        self.events = Events()
        self.registry = CollectorRegistry()
        self.metrics = (metrics if port else agent_metrics).AgentMetrics(
            registry=self.registry)
        self.kube = (KubeClient if port else AgentKube)(api_url)
        obs = dict(events=self.events, metrics=self.metrics,
                   node_name="node-a", timeline=gen.timeline, clock=clock)
        self.drain = (drain if port else agent_drain).DrainOrchestrator(
            operator=gen.operator, plugin=gen.plugin, storage=gen.storage,
            sitter=node.sitter, reconciler=gen.reconciler,
            kube_client=self.kube, deadline_s=deadline_s,
            preemption_notice_s=notice_s, node_poll_ttl_s=0.0, **obs)
        self.migration = (migration if port
                          else agent_migration).MigrationCoordinator(
            storage=gen.storage, plugin=gen.plugin, sitter=node.sitter,
            reconciler=gen.reconciler, drain=self.drain,
            kube_client=self.kube, alloc_spec_dir=node.alloc_dir, **obs)
        gen.reconciler.drain = self.drain
        gen.reconciler.migration = self.migration
        self.drain.migration = self.migration
        self.sampler = (sampler_mod if port
                        else agent_sampler).UtilizationSampler(
            gen.operator, storage=gen.storage, metrics=self.metrics,
            alloc_spec_dir=node.alloc_dir)

    def samples(self) -> dict:
        """The handshake's and the sampler's metric samples, keyed
        ``name{label=value,...}``."""
        text = generate_latest(self.registry).decode()
        return {
            s.name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(s.labels.items())) + "}":
            s.value
            for fam in text_string_to_metric_families(text)
            for s in fam.samples if s.name.startswith(HANDSHAKE_FAMILIES)
            and not s.name.endswith("_created")
        }

    def timeline(self) -> list:
        """(kind, attrs) of the handshake's timeline rows, in order."""
        return [(r["kind"], r["attrs"]) for r in
                self.gen.storage.timeline_rows()
                if r["kind"] in HANDSHAKE_KINDS]

    def snapshot(self) -> dict:
        """What the node shows: the drain's and the coordinator's status,
        the node's links, specs and records, the Events, the cordon, the
        samples and the timeline."""
        drain_status = dict(self.drain.status(), last_error=None)
        mig = self.migration.status()
        return dict(
            drain=drain_status, migration=mig, state=self.node.state(),
            events=list(self.events.posted),
            cordoned=self.gen.plugin.core.cordoned,
            samples=self.samples(), timeline=self.timeline(),
        )


# the handshake node's binds: pod a (a slice member) 50 core units and a
# quarter of the memory of card 2, pod b 100 core units of card 1
HANDSHAKE_SETS = [("core", 2, range(50)), ("mem", 2, range(UNITS // 4)),
                  ("core", 1, range(100))]


def hash_map(sets):
    """The port's hash of each device set (kind, card, units) -> the
    agent's."""
    port, agent = Node.__new__(Node), Node.__new__(Node)
    port.port, agent.port = True, False
    return {port.device(k, port.ids(k, c, u)).hash:
            agent.device(k, agent.ids(k, c, u)).hash
            for k, c, u in sets}


class HandshakeSide:
    """One side's node with pods a and b bound (HANDSHAKE_SETS), a fake
    apiserver holding the node and pod a, and a ``Handshake``."""

    def __init__(self, port: bool, deadline_s=300.0, notice_s=30.0,
                 clock=None):
        self.port = port
        self.root = tempfile.mkdtemp(prefix="hs", dir="/tmp")
        self.api = FakeAPIServer()
        self.url = self.api.start()
        self.api.add_node("node-a")
        self.node = Node(self.root, port)
        self.clock = clock if clock is not None else clock_of(port)
        self.limits = (deadline_s, notice_s)
        self.faults = faults if port else agent_faults
        self.boot()
        self.admit("a", "2", uid="uid-a", slice_id="job-1")
        self.admit("b", "1", uid="uid-b")
        for kind, chip, units in HANDSHAKE_SETS:
            self.bind(kind, "a" if chip == 2 else "b", chip, units)

    def bind(self, kind, pod, chip, units):
        """``Node.bind`` under a trace, as PreStart binds: the spec
        carries its id."""
        tracer = (tracing if self.port else agent_tracing).get_tracer()
        with tracer.trace("PreStartContainer"):
            return self.node.bind(kind, pod, chip, units)

    def admit(self, pod, chips, uid, slice_id=""):
        """The pod at the sitter (with its uid) and at the apiserver."""
        self.node.annotate(pod, chips)
        meta = self.node.sitter.pods[("default", pod)]["metadata"]
        meta["uid"] = uid
        if slice_id:
            meta["annotations"][AnnotationSliceID] = slice_id
        self.api.upsert_pod({"metadata": {"namespace": "default",
                                          "name": pod, "uid": uid,
                                          "annotations": {}}})

    def hash(self, kind, chip, units):
        return self.node.device(kind, self.node.ids(kind, chip, units)).hash

    def boot(self):
        """A new generation (an agent restart) with its handshake."""
        self.node.boot(timeline=True, clock=self.clock)
        self.hs = Handshake(self.node, self.url, self.clock, *self.limits)
        return self.hs

    def exit_pod(self, pod):
        """The pod goes (sitter, apiserver and kubelet) and the reconciler
        reclaims what it still holds."""
        self.node.sitter.remove_pod("default", pod)
        self.api.delete_pod("default", pod)
        self.node.kubelet.unassign_pod("default", pod)
        self.node.gen.reconciler.reconcile_once()

    def close(self):
        self.node.close()
        self.api.stop()
        shutil.rmtree(self.root, ignore_errors=True)


# the repartition node's pods, all on card 0: d (40 core units and a
# quarter of the memory, high), b (20 and a quarter, high), o (10, low)
# and l (20, low)
REP_SETS = [("core", 0, range(0, 40)), ("mem", 0, range(UNITS // 4)),
            ("core", 0, range(40, 60)),
            ("mem", 0, range(UNITS // 4, UNITS // 2)),
            ("core", 0, range(60, 70)), ("core", 0, range(70, 90))]
REP_PODS = {"d": ("high", (0, 1)), "b": ("high", (2, 3)),
            "o": ("low", (4,)), "l": ("low", (5,))}
# the metric families and timeline kinds the controller and the ledger
# feed, beside the handshake's
REP_FAMILIES = HANDSHAKE_FAMILIES + (
    "elastic_tpu_repartitions", "elastic_tpu_throttles",
    "elastic_tpu_qos_evictions", "elastic_tpu_goodput",
    "elastic_tpu_downtime")
REP_KINDS = HANDSHAKE_KINDS + ("repartition", "throttle",
                               "reconcile_repair", "bind_replay")
QUOTA_KEYS = ("ELASTIC_TPU_CORE_UNITS", "ELASTIC_TPU_HBM_LIMIT_BYTES",
              "ELASTIC_TPU_HBM_FRACTION", "ELASTIC_TPU_THROTTLE",
              "ELASTIC_TPU_THROTTLE_DEADLINE")


class RepartitionSide(HandshakeSide):
    """One side's node with REP_PODS bound on card 0 (``pods`` of them,
    each pod's ``annotations`` added), its handshake and its repartition
    controller on the side's clock."""

    def __init__(self, port: bool, pods=tuple(REP_PODS), annotations=None):
        self.port = port
        self.root = tempfile.mkdtemp(prefix="rp", dir="/tmp")
        self.api = FakeAPIServer()
        self.url = self.api.start()
        self.api.add_node("node-a")
        self.node = Node(self.root, port)
        self.clock = clock_of(port)
        self.limits = (300.0, 30.0)
        self.faults = faults if port else agent_faults
        self.boot()
        for pod in pods:
            priority, sets = REP_PODS[pod]
            self.admit(pod, "0", uid=f"uid-{pod}")
            self.annotate(pod, {AnnotationRepartition: "true",
                                AnnotationQoSPriority: priority,
                                **(annotations or {}).get(pod, {})})
            for i in sets:
                self.bind(*REP_SETS[i][:1], pod, *REP_SETS[i][1:])

    def boot(self):
        """A new generation with its handshake and controller, wired as
        the manager wires them (an agent restart)."""
        hs = super().boot()
        gen = self.node.gen
        self.rep = (repartition if self.port
                    else agent_repartition).RepartitionController(
            sampler=hs.sampler, storage=gen.storage, sitter=self.node.sitter,
            plugin=gen.plugin, reconciler=gen.reconciler, metrics=hs.metrics,
            events=hs.events, timeline=gen.timeline, node_name="node-a",
            clock=self.clock)
        gen.reconciler.repartition = self.rep
        hs.sampler.grant_adjust_fn = self.rep.core_delta_percent
        hs.sampler.repartition_status_fn = self.rep.status
        self.rep.migration = hs.migration
        return hs

    def annotate(self, pod, annotations):
        """Pod-controlled annotations, read live from the sitter."""
        meta = self.node.sitter.pods[("default", pod)]["metadata"]
        meta["annotations"].update(annotations)

    def core_hash(self, pod):
        kind, chip, units = REP_SETS[REP_PODS[pod][1][0]]
        return self.hash(kind, chip, units)

    def report(self, reports):
        """Each pod's usage report (percent) at the clock's time, as the
        pod side writes it."""
        for pod, duty in reports.items():
            path = os.path.join(self.node.alloc_dir, "usage")
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, f"{self.core_hash(pod)}.json"),
                      "w") as f:
                json.dump({"ts": self.clock.time(),
                           "duty_cycle_percent": float(duty),
                           "hbm_used_bytes": 0}, f)

    def cycle(self, reports, sample=True):
        """Reports written, one second on, a sample (``sample``), a
        controller tick; the tick's counts."""
        self.report(reports)
        self.clock.advance(1)
        if sample:
            self.hs.sampler.sample_once(now=self.clock.time())
        return self.rep.tick()

    def quotas(self):
        """Each spec's quota and throttle keys."""
        return {name: {k: v for k, v in spec.get("env", {}).items()
                       if k in QUOTA_KEYS}
                for name, spec in self.node.state()["specs"].items()}

    def close(self):
        self.node.close()
        # the apiserver's shutdown waits out its 0.5 s poll: off the
        # test's path
        threading.Thread(target=self.api.stop, daemon=True).start()
        shutil.rmtree(self.root, ignore_errors=True)

    def snapshot(self):
        """The controller's status, the quotas, the records, the Events,
        the samples and the timeline rows."""
        text = generate_latest(self.hs.registry).decode()
        samples = {
            s.name + "{" + ",".join(
                f"{k}={v}" for k, v in sorted(s.labels.items())) + "}":
            s.value
            for fam in text_string_to_metric_families(text)
            for s in fam.samples if s.name.startswith(REP_FAMILIES)
            and not s.name.endswith("_created")}
        return dict(
            status=self.rep.status(), quotas=self.quotas(),
            records=sorted(self.node.state()["records"]),
            events=list(self.hs.events.posted), samples=samples,
            timeline=[(r["kind"], r["keys"].get("pod"), r["attrs"])
                      for r in self.node.gen.storage.timeline_rows()
                      if r["kind"] in REP_KINDS])
