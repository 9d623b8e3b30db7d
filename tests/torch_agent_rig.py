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
"""

import json
import os
import re

from elastic_tpu_agent import rpc as agent_rpc
from elastic_tpu_agent import reconciler as agent_reconciler
from elastic_tpu_agent import timeline as agent_timeline
from elastic_tpu_agent.kube import locator as agent_locator
from elastic_tpu_agent.plugins import tpushare
from elastic_tpu_agent.plugins.base import PluginConfig as AgentConfig
from elastic_tpu_agent.storage import Storage as AgentStorage
from elastic_tpu_agent.types import Device as AgentDevice
from elastic_tpu_agent_torch import reconciler, rpc
from elastic_tpu_agent_torch import timeline as timeline_mod
from elastic_tpu_agent_torch.common import (
    AnnotationAssumed,
    BytesPerMemoryUnit,
    ResourceGPUCore,
    ResourceGPUMemory,
    container_annotation,
)
from elastic_tpu_agent_torch.device import StubOperator
from elastic_tpu_agent_torch.device.stub import H100_SXM5_HBM_BYTES
from elastic_tpu_agent_torch.kube import locator
from elastic_tpu_agent_torch.plugins import gpushare
from elastic_tpu_agent_torch.plugins.base import PluginConfig
from elastic_tpu_agent_torch.storage import Storage
from elastic_tpu_agent_torch.types import Device

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
