"""The PyTorch port imports neither JAX (nor optax or orbax) nor the JAX
package: every module of elastic_tpu_agent_torch imports in a fresh
interpreter where importing jax, optax or orbax fails, and no
elastic_tpu_agent module gets loaded. The agent side (plugins, nri with
its ttrpc and mux, rpc, gen, slices (packing, the registry and the
reformer) with the slice env, storage, kube, supervisor,
reconciler, manager, cli, faults, tracing, the native helpers' builder,
and the observability plane: events, timeline, the batcher, async_sink,
kube.events, crd, crd_recorder, latency, profiler, metrics; the
utilization sampler, the drain, the migration coordinator, the
repartition controller and the goodput ledger; the fleet simulator,
``sim/``; and the perf-regression ledger, ``bench_history``, with a
``perf-gate`` run through the CLI) loads no torch, a fleet of the port's
agents started with jax blocked loads neither torch nor the JAX package
(its fake kubelet is the port's own), its allocation logic and plain injection run with grpc and
protobuf absent too, the node agent's modules (the NRI server's included)
import with grpc, protobuf and requests absent, a manager with an NRI
socket builds without them, and so does one with the sampler, the drain
and the migration coordinator on, which sample and tick, and one with the
repartition controller and the goodput ledger on, which tick; only metrics
needs prometheus_client, and chip_smoke.py and the NRI runtime stand-in it
loads import nothing of the JAX package.

The agent side keeps its own copies of what it reads of the pod side
(whose package imports torch): ``common.py``'s handshake and throttle
keys equal ``workloads/contract.py``'s, and ``migration.py``'s ack reader,
``world_size_of`` and delta-chain check answer as ``workloads/
lifecycle.py`` and ``checkpointing.py`` on the same files."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "optax", "orbax"):
    sys.modules[blocked] = None    # any `import jax` etc. now raises
import elastic_tpu_agent_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m.split(".")[0] == "elastic_tpu_agent"
    or m.startswith("jax") and sys.modules[m] is not None
)
new = {"export", "parallel", "ring_attention", "pipeline",
       "transformer_pipeline", "partitioner", "serving_proxy",
       "topology", "operator", "nvidia", "stub", "exclusive", "qos",
       "gpushare", "base", "packing", "plugin", "rpc", "types",
       "deviceplugin_pb2", "store", "supervisor", "client", "sitter",
       "locator", "reconciler", "manager", "cli", "faults", "tracing",
       "podresources_pb2", "podresources_v1_pb2", "events", "timeline",
       "batcher", "async_sink", "crd", "crd_recorder", "metrics",
       "latency", "profiler", "ttrpc", "mux", "ttrpc_pb2", "build",
       "sampler", "drain", "migration", "repartition", "goodput",
       "slice_env", "registry", "recovery", "traffic", "aggregator",
       "fleet", "scale", "chaos", "bench_history"}
missing = sorted(new - {n.rsplit(".", 1)[-1] for n in names})
print(len(names), missing, leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    count, missing, leaked = res.stdout.strip().split(" ", 2)
    assert int(count) >= 97         # workloads and every module in it,
    #                                 the device layer, the agent side,
    #                                 the fleet simulator, bench_history
    assert missing == "[]"          # export, mesh, ring, pipelines, serving,
    #                                 the device layer, plugins, injection
    assert leaked == "[]"


AGENT_SIDE = r"""
import importlib, sys
for blocked in ("torch", "jax", "elastic_tpu_agent"):
    sys.modules[blocked] = None
for name in ("plugins", "plugins.base", "plugins.gpushare", "nri",
             "nri.plugin", "nri.ttrpc", "nri.mux", "rpc", "gen",
             "gen.deviceplugin_pb2", "gen.nri_pb2", "gen.ttrpc_pb2",
             "native", "native.build", "gen.podresources_pb2",
             "gen.podresources_v1_pb2", "slices", "slices.packing",
             "slices.registry", "slices.recovery", "slice_env", "types",
             "storage", "storage.store", "kube", "kube.client",
             "kube.sitter", "kube.locator", "supervisor", "reconciler",
             "manager", "cli", "faults", "tracing", "common", "device",
             "events", "timeline", "storage.batcher", "async_sink",
             "kube.events", "crd", "crd_recorder", "latency", "profiler",
             "metrics", "sampler", "drain", "migration", "repartition",
             "goodput", "sim", "sim.traffic", "sim.aggregator", "sim.fleet",
             "sim.scale", "sim.chaos", "bench_history"):
    importlib.import_module("elastic_tpu_agent_torch." + name)
# the perf gate through the CLI, over the committed rounds
from elastic_tpu_agent_torch import cli
rc = cli.main(["perf-gate", "--root", ".", "--self-test"])
print(rc, sorted(m for m in sys.modules if sys.modules[m] is not None and
                 m.split(".")[0] in ("torch", "jax", "elastic_tpu_agent")))
"""

# a 1-node fleet of the port's agents started and stopped with jax blocked:
# the fakes load at start() (the port's fake kubelet and the stand-alone
# apiserver), which an import-only probe cannot see; neither the JAX
# package nor torch gets loaded
FLEET = r"""
import sys, tempfile
sys.modules["jax"] = None
from elastic_tpu_agent_torch.sim import FleetSim
with tempfile.TemporaryDirectory(prefix="etpu-ig", dir="/tmp") as tmp:
    sim = FleetSim(tmp, nodes=1, reconcile_period_s=30.0)
    sim.start()
    try:
        refs = sim.admit_pods(1)
        sim.wait_synced(refs)
        sim.bind_pod(refs[0])
        bound = sim.stored_binds()
    finally:
        sim.stop()
print(bound, sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("torch", "jax",
                                            "elastic_tpu_agent")),
      "torch_fake_kubelet" in sys.modules, "fake_kubelet" in sys.modules)
"""

# the allocation logic and the plain injection with grpc, protobuf and
# torch absent: a shared allocation through the bundle (preferred ids,
# Allocate, PreStart, spec), then its adjustment
PLAIN = r"""
import os, sys, tempfile
for blocked in ("torch", "grpc", "google.protobuf"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch.common import (AnnotationAssumed,
                                            container_annotation)
from elastic_tpu_agent_torch.device import StubOperator
from elastic_tpu_agent_torch.nri.plugin import plain_adjustment
from elastic_tpu_agent_torch.plugins.base import PluginConfig
from elastic_tpu_agent_torch.plugins.gpushare import GPUSharePlugin
from elastic_tpu_agent_torch.types import PodContainer, PodInfo

class Storage:
    def __init__(self):
        self.pods = {}
    def load(self, ns, name):
        return self.pods.get(f"{ns}/{name}")
    def mutate(self, ns, name, fn):
        fn(self.pods.setdefault(f"{ns}/{name}", PodInfo(ns, name)))
    def journal_intent(self, *args):
        return 1
    def journal_commit(self, i): pass
    def journal_remove(self, i): pass
    def intent_done(self, i): pass

class Sitter:
    pod = {"metadata": {"annotations": {AnnotationAssumed: "true",
                                        container_annotation("main"): "1"}}}
    def get_pod(self, ns, name):
        return self.pod

class Locator:
    def locate(self, device):
        return PodContainer("default", "p", "main")

tmp = tempfile.mkdtemp()
op = StubOperator(os.path.join(tmp, "dev"), num_chips=2, minors=[1, 0])
os.makedirs(os.path.join(tmp, "dev"))
bundle = GPUSharePlugin(PluginConfig(
    operator=op, sitter=Sitter(), storage=Storage(),
    locator_factory=lambda res: Locator(),
    extra={"alloc_spec_dir": os.path.join(tmp, "alloc")}))
core = bundle.core
ids = core.preferred_ids([i for i, _ in core.device_list()], [], 30)
alloc = core.allocate_container(ids)
core.pre_start(ids)
spec = core.read_alloc_spec(alloc.envs["TPU"])
adj = plain_adjustment(spec, stat_fn=lambda p: os.stat("/dev/null")
                       if "nvidia" in p else os.stat(p))
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and
                (m.split(".")[0] in ("torch", "grpc")
                 or m.startswith("google.protobuf")))
print(len(ids), [d.host_path for d in alloc.devices],
      [d["path"] for d in adj["devices"]], leaked)
"""


# the node agent's modules with grpc, protobuf and requests absent too (the
# card's machine has none of them): only rpc and the generated messages
# need grpc or protobuf, and they are imported where a server or the
# pod-resources client starts
NODE_AGENT = r"""
import importlib, sys
for blocked in ("torch", "jax", "elastic_tpu_agent", "grpc",
                "google.protobuf", "requests"):
    sys.modules[blocked] = None
for name in ("manager", "cli", "storage", "storage.store", "kube",
             "kube.client", "kube.sitter", "kube.locator", "reconciler",
             "supervisor", "faults", "tracing", "plugins.gpushare", "nri",
             "nri.plugin", "native.build", "slice_env", "slices.registry",
             "slices.recovery", "events", "timeline", "storage.batcher", "async_sink",
             "kube.events", "crd", "crd_recorder", "latency", "profiler",
             "metrics", "sampler", "drain", "migration", "repartition",
             "goodput"):
    importlib.import_module("elastic_tpu_agent_torch." + name)
print(sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("torch", "jax", "elastic_tpu_agent", "grpc",
                        "requests") or m.startswith("google.protobuf"))))
"""


# an agent without --metrics-port: the manager with its whole
# observability plane but no AgentMetrics never imports prometheus_client
NO_PROMETHEUS = r"""
import os, sys, tempfile
for blocked in ("torch", "prometheus_client", "grpc", "google.protobuf"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch import cli
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

class PodResources:
    def list(self):
        return type("R", (), {"pod_resources": []})()

root = tempfile.mkdtemp(dir="/tmp")
os.makedirs(os.path.join(root, "dev"))
mgr = NodeManager(ManagerOptions(
    node_name="node-a", db_path=os.path.join(root, "meta.db"),
    operator_kind="stub:1", dev_root=os.path.join(root, "dev"),
    kube_client=KubeClient("http://127.0.0.1:9"),
    pod_resources_client=PodResources(), storage_batch_window_s=0.005))
mgr.timeline.emit("agent_started")
kinds = [e["kind"] for e in mgr.timeline.events()]
mgr.stop()
print(kinds, mgr.bus is not None, mgr.crd_recorder is not None,
      mgr.events is not None,
      sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("torch", "prometheus_client")))
"""


# a manager with an NRI socket and the eviction policy, before it serves:
# the NRI server imports protobuf only when its session starts
NRI_MANAGER = r"""
import os, sys, tempfile
for blocked in ("torch", "grpc", "google.protobuf", "elastic_tpu_agent"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

class PodResources:
    def list(self):
        return type("R", (), {"pod_resources": []})()

root = tempfile.mkdtemp(dir="/tmp")
os.makedirs(os.path.join(root, "dev"))
mgr = NodeManager(ManagerOptions(
    node_name="node-a", db_path=os.path.join(root, "meta.db"),
    operator_kind="stub:1", dev_root=os.path.join(root, "dev"),
    kube_client=KubeClient("http://127.0.0.1:9"),
    pod_resources_client=PodResources(), enable_event_bus=False,
    enable_events=False, enable_crd=False,
    nri_socket=os.path.join(root, "nri.sock"),
    nri_evict_on_chip_failure=True))
hooked = mgr.plugin.on_chips_failed == mgr.nri_plugin.evict_for_chips
mgr.stop()
print(hooked, sorted(m for m in sys.modules if sys.modules[m] is not None
                     and (m.split(".")[0] in ("torch", "grpc")
                          or m.startswith("google.protobuf"))))
"""

# a manager with the sampler, the drain and the migration coordinator on
# (the defaults), each driven once by hand: no torch, grpc or protobuf
HANDSHAKE_MANAGER = r"""
import os, sys, tempfile
for blocked in ("torch", "grpc", "google.protobuf", "elastic_tpu_agent"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

class PodResources:
    def list(self):
        return type("R", (), {"pod_resources": []})()

root = tempfile.mkdtemp(dir="/tmp")
os.makedirs(os.path.join(root, "dev"))
mgr = NodeManager(ManagerOptions(
    node_name="", db_path=os.path.join(root, "meta.db"),
    operator_kind="stub:1", dev_root=os.path.join(root, "dev"),
    alloc_spec_dir=os.path.join(root, "alloc"),
    kube_client=KubeClient("http://127.0.0.1:9"),
    pod_resources_client=PodResources(), enable_event_bus=False,
    enable_events=False, enable_crd=False))
mgr.sampler.sample_once()
state = mgr.drain.tick()
mgr.migration.tick()
rows = [r["chip"] for r in mgr.sampler.allocations_snapshot()["chips"]]
mgr.stop()
print(state, rows, sorted(m for m in sys.modules if sys.modules[m] is not None
                          and (m.split(".")[0] in ("torch", "grpc")
                               or m.startswith("google.protobuf"))))
"""

# a manager with the repartition controller and the goodput ledger on
# (the defaults), each ticked by hand, the block of /debug/allocations and
# the ledger's status read: no torch, grpc or protobuf
REPARTITION_MANAGER = r"""
import os, sys, tempfile
for blocked in ("torch", "grpc", "google.protobuf", "elastic_tpu_agent"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

class PodResources:
    def list(self):
        return type("R", (), {"pod_resources": []})()

root = tempfile.mkdtemp(dir="/tmp")
os.makedirs(os.path.join(root, "dev"))
mgr = NodeManager(ManagerOptions(
    node_name="node-a", db_path=os.path.join(root, "meta.db"),
    operator_kind="stub:1", dev_root=os.path.join(root, "dev"),
    alloc_spec_dir=os.path.join(root, "alloc"),
    kube_client=KubeClient("http://127.0.0.1:9"),
    pod_resources_client=PodResources(), enable_event_bus=False,
    enable_events=False, enable_crd=False))
mgr.sampler.sample_once()
mgr.repartition.resume()
mgr.goodput.resume()
moved = mgr.repartition.tick()
mgr.goodput.tick()
block = mgr.sampler.allocations_snapshot()["repartition"]
wired = (mgr.reconciler.repartition is mgr.repartition
         and mgr.sampler.grant_adjust_fn == mgr.repartition.core_delta_percent
         and mgr.repartition.migration is mgr.migration)
problems = mgr.goodput.status()["conservation_problems"]
mgr.stop()
print(sorted(moved.values()), block["enabled"], wired, problems,
      sorted(m for m in sys.modules if sys.modules[m] is not None
             and (m.split(".")[0] in ("torch", "grpc")
                  or m.startswith("google.protobuf"))))
"""

# chip_smoke.py and the NRI runtime stand-in it loads from tests/, with the
# JAX package blocked: importing them loads none of it
CHIP_SMOKE = r"""
import importlib.util, sys
for blocked in ("jax", "elastic_tpu_agent"):
    sys.modules[blocked] = None
import chip_smoke
spec = importlib.util.spec_from_file_location("torch_nri_runtime",
                                              "tests/torch_nri_runtime.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "elastic_tpu_agent")))
"""


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip()


def test_agent_side_loads_no_torch_and_no_agent():
    assert _run(AGENT_SIDE) == "0 []"


def test_a_started_fleet_loads_no_jax_package_and_no_torch():
    assert _run(FLEET) == "{'sim-0': 1} [] True False"


def test_observability_plane_needs_no_prometheus_without_metrics():
    assert _run(NO_PROMETHEUS) == "['agent_started'] True True True []"


def test_node_agent_imports_without_grpc_protobuf_or_requests():
    assert _run(NODE_AGENT) == "[]"


def test_allocation_logic_runs_without_grpc_protobuf_or_torch():
    """Card 1 of the stub has minor 0; its node and the control nodes."""
    nodes = "['/dev/nvidiactl', '/dev/nvidia-uvm', '/dev/nvidia-uvm-tools']"
    assert _run(PLAIN) == (f"30 {nodes} ['/dev/nvidia0', '/dev/nvidiactl', "
                           "'/dev/nvidia-uvm', '/dev/nvidia-uvm-tools'] []")


def test_a_manager_with_an_nri_socket_loads_no_grpc_protobuf_or_torch():
    assert _run(NRI_MANAGER) == "True []"


def test_a_manager_with_the_handshake_on_loads_no_grpc_protobuf_or_torch():
    assert _run(HANDSHAKE_MANAGER) == "active [0] []"


def test_a_manager_with_repartition_and_goodput_loads_no_grpc_protobuf_or_torch(
        ):
    assert _run(REPARTITION_MANAGER) == "[0, 0, 0, 0] True True [] []"


def test_agent_side_copies_of_the_pod_contract_are_equal():
    from elastic_tpu_agent_torch import common
    from elastic_tpu_agent_torch.workloads import contract

    keys = [k for k in vars(contract) if k[0].isupper()]
    shared = [k for k in keys if hasattr(common, k)]
    # every key the agent side reads or writes, the throttle keys of the
    # repartition controller included
    assert set(keys) == set(shared)
    assert {"EnvThrottle", "EnvThrottleDeadline"} <= set(shared)
    assert {k: getattr(common, k) for k in shared} == {
        k: getattr(contract, k) for k in shared}
    assert common.AllocSidecarSubdirs == (
        contract.UsageReportSubdir, contract.AckSubdir,
        contract.FlightSummarySubdir)


def test_agent_side_scheduler_contract_equals_the_agents():
    """The scheduler's annotations and the slice env keys the port reads
    and writes keep the agent's spellings."""
    from elastic_tpu_agent import common as agent_common
    from elastic_tpu_agent_torch import common

    names = ("AnnotationAssumed", "AnnotationContainerPrefix",
             "AnnotationTraceID", "AnnotationSliceName",
             "AnnotationSliceWorkerID", "AnnotationSliceWorkerHosts",
             "AnnotationSliceID", "AnnotationDrain", "AnnotationDraining",
             "EnvSliceName", "EnvSliceEpoch")
    assert {n: getattr(common, n) for n in names} == {
        n: getattr(agent_common, n) for n in names}


def test_agent_side_ack_reader_and_world_size_agree_with_the_pod_side(
        tmp_path):
    import json

    from elastic_tpu_agent_torch import migration
    from elastic_tpu_agent_torch.workloads import checkpointing, lifecycle

    alloc = str(tmp_path / "alloc")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "state").write_bytes(b"x" * 100)
    acks = tmp_path / "alloc" / "ack"

    def both(h):
        got = migration.read_checkpoint_ack(alloc, h)
        assert got == lifecycle.read_checkpoint_ack(alloc, h)
        return got

    assert both("absent") is None
    lifecycle.write_checkpoint_ack(alloc, "ok", 7, str(ckpt), world_size=2)
    assert both("ok")["step"] == 7
    # a future-dated ack reads as it stands (the coordinator judges it)
    lifecycle.write_checkpoint_ack(alloc, "future", 3, ts=4e9)
    assert both("future")["ts"] == 4e9
    # a digest that does not match the directory reads as it stands too
    lifecycle.write_checkpoint_ack(alloc, "mismatch", 3, str(ckpt),
                                   digest="0" * 32)
    assert both("mismatch")["digest"] != lifecycle.checkpoint_digest(
        str(ckpt))
    (acks / "torn.json").write_text('{"ts": 1, "step"')
    (acks / "list.json").write_text(json.dumps([1, 2]))
    assert both("torn") is None and both("list") is None
    for env in ({}, {"TPU_WORKER_HOSTNAMES": ""},
                {"TPU_WORKER_HOSTNAMES": "a"},
                {"TPU_WORKER_HOSTNAMES": "a,b,,c"}):
        assert migration.world_size_of(env) == lifecycle.world_size_of(env)
    # the delta chain: whole, torn (a block gone) and corrupt (a block
    # rewritten), as DeltaCheckpointer.verify reads it
    delta = tmp_path / "delta"
    ckptr = checkpointing.DeltaCheckpointer(str(delta), block_size=16)
    ckptr.save(1, bytes(range(64)))
    ckptr.save(2, bytes(range(1, 65)))
    blocks = [delta / "blocks" / f"{d}.bin"
              for d in ckptr.read_manifest(2)["blocks"]]
    reports = [migration.verify_delta_chain(str(delta))]
    blocks[0].write_bytes(b"corrupt")
    reports.append(migration.verify_delta_chain(str(delta)))
    blocks[1].unlink()
    reports.append(migration.verify_delta_chain(str(delta)))
    assert [r["ok"] for r in reports] == [True, False, False]
    assert reports[-1] == ckptr.verify()
    assert migration.verify_delta_chain(str(tmp_path / "none")) == (
        checkpointing.DeltaCheckpointer(str(tmp_path / "none")).verify())


def test_chip_smoke_and_its_nri_stand_in_import_no_jax_package():
    assert _run(CHIP_SMOKE) == "[]"
    pattern = re.compile(r"^\s*(from|import)\s+elastic_tpu_agent(\.|\s|$)",
                         re.M)
    for rel in ("chip_smoke.py", os.path.join("tests",
                                              "torch_nri_runtime.py")):
        with open(os.path.join(ROOT, rel)) as f:
            assert not pattern.search(f.read()), rel
