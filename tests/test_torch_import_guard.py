"""The PyTorch port imports neither JAX (nor optax or orbax) nor the JAX
package: every module of elastic_tpu_agent_torch imports in a fresh
interpreter where importing jax, optax or orbax fails, and no
elastic_tpu_agent module gets loaded. The agent side (plugins, nri, rpc,
gen, slices) loads no torch, and its allocation logic and plain injection
run with grpc and protobuf absent too."""

import os
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
       "deviceplugin_pb2"}
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
    assert int(count) >= 44         # workloads and every module in it,
    #                                 the device layer, the agent side
    assert missing == "[]"          # export, mesh, ring, pipelines, serving,
    #                                 the device layer, plugins, injection
    assert leaked == "[]"


AGENT_SIDE = r"""
import importlib, sys
for blocked in ("torch", "jax", "elastic_tpu_agent"):
    sys.modules[blocked] = None
for name in ("plugins", "plugins.base", "plugins.gpushare", "nri",
             "nri.plugin", "rpc", "gen", "gen.deviceplugin_pb2",
             "gen.nri_pb2", "slices", "slices.packing", "types"):
    importlib.import_module("elastic_tpu_agent_torch." + name)
print(sorted(m for m in sys.modules if sys.modules[m] is not None and
             m.split(".")[0] in ("torch", "jax", "elastic_tpu_agent")))
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


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip()


def test_agent_side_loads_no_torch_and_no_agent():
    assert _run(AGENT_SIDE) == "[]"


def test_allocation_logic_runs_without_grpc_protobuf_or_torch():
    """Card 1 of the stub has minor 0; its node and the control nodes."""
    nodes = "['/dev/nvidiactl', '/dev/nvidia-uvm', '/dev/nvidia-uvm-tools']"
    assert _run(PLAIN) == (f"30 {nodes} ['/dev/nvidia0', '/dev/nvidiactl', "
                           "'/dev/nvidia-uvm', '/dev/nvidia-uvm-tools'] []")
