"""The port's node agent (``manager.py``, ``cli.py``) against the agent's.

``NodeManager`` runs beside the agent's ``TPUManager`` in the agent's
bind-path configuration (no event bus, events, CRD, sampler, migration,
repartition, metrics or NRI), each with a ``tests/fake_apiserver.py``, a
``tests/fake_kubelet.py`` and the port's 4-card stub, through the flow of
``tests/test_e2e.py``: both resources register, ListAndWatch gives ids
and health, an annotated pod is allocated and bound over gRPC, the agent
restarts with its links wiped (equal restore reports and state), restarts
with a pod deleted while it was down (reclaimed), and a pod deleted while
it runs is reclaimed by GC through the sitter's queue. The allocatable
cross-check, ``stop()`` twice, the CLI's flags and ``main()`` until
SIGTERM follow, and a node without grpc: its device-plugin servers crash
until the supervisor's breaker ends ``run(block=True)``.
"""

import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import cli as agent_cli  # noqa: E402
from elastic_tpu_agent.kube.client import KubeClient as AgentKube  # noqa: E402
from elastic_tpu_agent_torch import cli, rpc  # noqa: E402
from elastic_tpu_agent_torch.device import StubOperator  # noqa: E402
from elastic_tpu_agent_torch.kube.client import KubeClient  # noqa: E402
from elastic_tpu_agent_torch.manager import (  # noqa: E402
    ManagerOptions,
    NodeManager,
    build_operator,
)
from elastic_tpu_agent_torch.plugins import gpushare  # noqa: E402

from fake_apiserver import FakeAPIServer, make_pod  # noqa: E402
from fake_kubelet import FakeKubelet  # noqa: E402
from test_e2e import Cluster as AgentCluster  # noqa: E402
from torch_agent_rig import (  # noqa: E402
    AGENT_CORE,
    AGENT_MEM,
    MINORS,
    UNITS,
    Node,
    port_report,
    to_agent,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_NAME = "node-a"
# the agent's manager in its bind-path configuration
AGENT_BIND_PATH = dict(
    enable_event_bus=False, enable_events=False, enable_crd=False,
    enable_sampler=False, enable_migration=False, enable_repartition=False,
    nri_socket="")


def wait_until(fn, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


class PortCluster:
    """The port's NodeManager with a fake apiserver and kubelet around it:
    ``test_e2e.Cluster``'s shape."""

    def __init__(self, tmp_path, **opt_overrides):
        self.node = NODE_NAME
        self.apiserver = FakeAPIServer()
        url = self.apiserver.start()
        self.kubelet = FakeKubelet(str(tmp_path / "dp"),
                                   str(tmp_path / "pr" / "kubelet.sock"))
        self.kubelet.start()
        self.tmp = tmp_path
        (tmp_path / "dev").mkdir()
        self.opts = ManagerOptions(
            node_name=self.node, db_path=str(tmp_path / "meta.db"),
            dev_root=str(tmp_path / "dev"),
            device_plugin_dir=str(tmp_path / "dp"),
            pod_resources_socket=str(tmp_path / "pr" / "kubelet.sock"),
            alloc_spec_dir=str(tmp_path / "alloc"),
            kube_client=KubeClient(url), **opt_overrides)
        self.manager = NodeManager(self.opts)

    def start(self):
        self.manager.run(block=False)
        assert self.kubelet.wait_registrations(2), "agent did not register"

    def stop(self):
        self.manager.stop()
        self.kubelet.stop()
        self.apiserver.stop()


class Side:
    """One side's cluster and the kubelet's view of its plugins."""

    def __init__(self, port: bool):
        self.port = port
        self.root = pathlib.Path(tempfile.mkdtemp(prefix="mg", dir="/tmp"))
        self.names = Node.__new__(Node)       # ids and resources only
        self.names.port = port
        stub = StubOperator(str(self.root / "dev"), num_chips=4,
                            minors=MINORS)
        if port:
            self.c = PortCluster(self.root, operator=stub)
        else:
            self.c = AgentCluster(self.root, operator=stub,
                                  **AGENT_BIND_PATH)
        self.managers = [self.c.manager]

    @property
    def manager(self):
        return self.c.manager

    def endpoint(self, kind):
        from elastic_tpu_agent.plugins import tpushare

        mod = gpushare if self.port else tpushare
        return mod.CORE_ENDPOINT if kind == "core" else mod.MEM_ENDPOINT

    def client(self, kind):
        path = os.path.join(self.c.opts.device_plugin_dir,
                            self.endpoint(kind))
        if self.port:
            return rpc.DevicePluginClient(rpc.dial(path))
        return self.c.kubelet.plugin_client(self.endpoint(kind))

    def first_list(self, kind):
        return [(d.ID, d.health) for d in next(iter(
            self.client(kind).list_and_watch())).devices]

    def add_pod(self, pod, chips):
        self.c.apiserver.upsert_pod(make_pod(
            "default", pod, NODE_NAME, annotations={
                "elasticgpu.io/assumed": "true",
                "elasticgpu.io/container-main": chips}))
        assert wait_until(lambda: self.manager.sitter.get_pod(
            "default", pod) is not None)

    def bind(self, kind, pod, chip, units):
        """Allocate, the kubelet's assignment, PreStart: over gRPC."""
        ids = self.names.ids(kind, chip, units)
        cl = self.client(kind)
        resp = cl.allocate(ids)
        self.c.kubelet.assign("default", pod, "main",
                              self.names.res(kind), ids)
        cl.pre_start_container(ids)
        return dict(resp.container_responses[0].envs)

    def restart(self):
        """Stop the agent and boot a new one over the same node."""
        self.manager.stop()
        n = len(self.c.kubelet.registrations)
        mgr = (NodeManager if self.port else type(self.manager))(self.c.opts)
        self.c.manager = mgr
        self.managers.append(mgr)
        mgr.run(block=False)
        assert self.c.kubelet.wait_registrations(n + 2)
        return mgr.reconciler.status()["last_report"]

    def state(self):
        dev = self.c.opts.dev_root
        alloc = self.c.opts.alloc_spec_dir
        specs = {}
        for name in sorted(os.listdir(alloc)) if os.path.isdir(alloc) else []:
            if name.endswith(".json"):
                with open(os.path.join(alloc, name)) as f:
                    specs[name] = json.load(f)
        return dict(
            links={n: os.readlink(os.path.join(dev, n))
                   for n in sorted(os.listdir(dev))},
            specs=specs,
            records={k: json.loads(v.to_json())
                     for k, v in self.manager.storage.items()},
            intents=len(self.manager.storage.open_intents()),
        )

    def close(self):
        self.c.stop()
        shutil.rmtree(self.root, ignore_errors=True)


# every device set the flow binds, as (kind, chip, units)
BINDS = [("core", "train", 2, range(50)), ("mem", "train", 2,
                                           range(UNITS // 4)),
         ("core", "gone", 0, range(100)), ("core", "web", 1, range(25))]


def hash_map():
    port, agent = Node.__new__(Node), Node.__new__(Node)
    port.port, agent.port = True, False
    return {port.device(k, port.ids(k, c, u)).hash:
            agent.device(k, agent.ids(k, c, u)).hash
            for k, _, c, u in BINDS}


def flow(port: bool) -> dict:
    s = Side(port)
    out = {}
    try:
        s.c.start()
        out["registrations"] = sorted(
            (r.version, r.resource_name, r.endpoint,
             r.options.pre_start_required) for r in s.c.kubelet.registrations)
        out["lists"] = {k: s.first_list(k) for k in ("core", "mem")}
        for pod, chips in (("train", "2"), ("gone", "0"), ("web", "1")):
            s.add_pod(pod, chips)
        out["envs"] = [s.bind(k, p, c, u) for k, p, c, u in BINDS]
        out["bound"] = s.state()
        # restart 1: a reboot wiped the links
        for name in os.listdir(s.c.opts.dev_root):
            os.unlink(os.path.join(s.c.opts.dev_root, name))
        out["restore_links"] = s.restart()
        out["after_links"] = s.state()
        # restart 2: a pod deleted while no agent ran
        s.manager.stop()
        s.c.apiserver.delete_pod("default", "gone")
        s.c.kubelet.unassign_pod("default", "gone")
        out["restore_dead"] = s.restart()
        out["after_dead"] = s.state()
        # a pod deleted while the agent runs: GC through the sitter
        s.c.apiserver.delete_pod("default", "web")
        s.c.kubelet.unassign_pod("default", "web")
        t0 = time.monotonic()
        out["gc_reclaimed"] = wait_until(
            lambda: s.manager.storage.load("default", "web") is None)
        out["gc_s"] = time.monotonic() - t0
        out["after_gc"] = s.state()
        # the allocatable cross-check: the kubelet counts cards 0-2 and a
        # card 5 this node does not have
        core = s.names.res("core")
        s.c.kubelet.allocatable = {core: s.names.ids("core", 0, [0]) +
                                   s.names.ids("core", 1, [0]) +
                                   s.names.ids("core", 2, [0]) +
                                   s.names.ids("core", 5, [0])}
        out["drift"] = s.manager.check_allocatable_drift()
        s.c.kubelet.allocatable = {}
        out["no_view"] = s.manager.check_allocatable_drift()
        out["subsystems"] = sorted(s.manager.supervisor.status())
        s.manager.stop()
        s.manager.stop()        # idempotent
        return out
    finally:
        s.close()


@pytest.fixture(scope="module")
def flows():
    return {"port": flow(True), "agent": flow(False)}


def test_registrations_and_lists_match_the_agents(flows):
    port, agent = flows["port"], flows["agent"]
    assert to_agent([list(r) for r in port["registrations"]], {}) == \
        [list(r) for r in agent["registrations"]]
    for kind in ("core", "mem"):
        assert to_agent(port["lists"][kind], {}) == \
            [list(d) for d in agent["lists"][kind]]
    assert len(port["lists"]["mem"]) == 4 * UNITS


def test_allocate_envs_and_binds_match_the_agents(flows):
    hashes = hash_map()
    port, agent = flows["port"], flows["agent"]
    assert to_agent(port["envs"], hashes) == to_agent(agent["envs"], {})
    assert to_agent(port["bound"], hashes) == to_agent(agent["bound"], {})
    assert len(port["bound"]["links"]) == 4
    assert port["bound"]["intents"] == 0


@pytest.mark.parametrize("restart", ["links", "dead"])
def test_restore_after_a_restart_matches_the_agents(flows, restart):
    hashes = hash_map()
    port, agent = flows["port"], flows["agent"]
    rp = {k: v for k, v in port[f"restore_{restart}"].items()
          if k != "duration_s"}
    assert rp == port_report(agent[f"restore_{restart}"])
    after = f"after_{restart}"
    assert to_agent(port[after], hashes) == to_agent(agent[after], {})
    if restart == "links":
        assert rp["restored_links"] == 4 and rp["repaired_total"] == 4
        assert port["after_links"]["links"] == port["bound"]["links"]
    else:
        assert rp["reclaimed_pods"] == 1
        assert sorted(port["after_dead"]["records"]) == ["default/train",
                                                         "default/web"]


def test_gc_reclaims_a_pod_deleted_while_up_as_the_agent(flows):
    hashes = hash_map()
    port, agent = flows["port"], flows["agent"]
    assert port["gc_reclaimed"] and agent["gc_reclaimed"]
    assert port["gc_s"] < 10
    assert to_agent(port["after_gc"], hashes) == to_agent(agent["after_gc"],
                                                          {})
    assert sorted(port["after_gc"]["records"]) == ["default/train"]


def test_allocatable_drift_matches_the_agents(flows):
    port, agent = flows["port"], flows["agent"]
    assert to_agent(port["drift"], {}) == {
        AGENT_CORE: {"missing": [3], "extra": [5]}} == agent["drift"]
    assert port["no_view"] == agent["no_view"] == {}
    assert AGENT_MEM not in agent["drift"]


def test_subsystems_are_the_agents_bind_path(flows):
    port, agent = flows["port"], flows["agent"]
    assert set(to_agent(port["subsystems"], {})) <= set(agent["subsystems"])
    assert port["subsystems"] == [
        "allocatable-check", "device-plugin:elasticgpu.io/gpu-core",
        "device-plugin:elasticgpu.io/gpu-memory", "gc", "health",
        "reconciler", "sitter"]


# -- the CLI -------------------------------------------------------------------

PORTED_FLAGS = [
    "--node-name", "n1", "--db-file", "/x/meta.db", "--kubeconf", "/x/kc",
    "--operator", "stub:2", "--dev-root", "/x/dev",
    "--device-plugin-dir", "/x/dp", "--pod-resources-socket", "/x/pr.sock",
    "--alloc-spec-dir", "/x/alloc", "--dp-pool-size", "3",
    "--crash-loop-threshold", "4", "--reconcile-period", "7.5",
    "--reconcile-dry-run", "--faults", "gc.sweep=raise-once", "-v"]


@pytest.mark.parametrize("argv", [PORTED_FLAGS, []], ids=["flags",
                                                          "defaults"])
def test_parse_args_matches_the_agents(argv):
    port = vars(cli.parse_args(argv))
    agent = vars(agent_cli.parse_args(argv))
    assert set(port) <= set(agent)
    differ = {k: (port[k], agent[k]) for k in port if port[k] != agent[k]}
    # the port's operator is nvidia where the agent's is tpuvm
    assert differ == ({} if argv else {"operator": ("nvidia", "tpuvm")})
    opts = cli.options_from_args(cli.parse_args(argv))
    if argv:
        assert (opts.node_name, opts.operator_kind, opts.dp_pool_size,
                opts.crash_loop_threshold, opts.reconcile_period_s,
                opts.reconcile_dry_run) == ("n1", "stub:2", 3, 4, 7.5, True)


def test_build_operator_kinds(tmp_path):
    opts = ManagerOptions(dev_root=str(tmp_path), operator_kind="stub:3")
    assert len(build_operator(opts).devices()) == 3
    opts.operator_kind = "exclusive:stub:2"
    op = build_operator(opts)
    assert not op.virtual_nodes and len(op.devices()) == 2
    opts.operator_kind = "tpuvm"
    with pytest.raises(ValueError):
        build_operator(opts)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_main_runs_until_sigterm():
    root = pathlib.Path(tempfile.mkdtemp(prefix="cl", dir="/tmp"))
    api = FakeAPIServer()
    url = api.start()
    kubelet = FakeKubelet(str(root / "dp"), str(root / "pr.sock"))
    kubelet.start()
    kc = root / "kubeconfig"
    kc.write_text(json.dumps({
        "current-context": "c",
        "contexts": [{"name": "c", "context": {"cluster": "k",
                                               "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t"}}]}))
    (root / "dev").mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elastic_tpu_agent_torch.cli",
         "--node-name", NODE_NAME, "--db-file", str(root / "meta.db"),
         "--kubeconf", str(kc), "--operator", "stub:2",
         "--dev-root", str(root / "dev"), "--device-plugin-dir",
         str(root / "dp"), "--pod-resources-socket", str(root / "pr.sock"),
         "--alloc-spec-dir", str(root / "alloc")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert kubelet.wait_registrations(2, timeout=30), proc.stderr
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        err = proc.stderr.read()
        assert "exiting on signal" in err
        assert os.path.exists(root / "meta.db")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop()
        api.stop()
        shutil.rmtree(root, ignore_errors=True)


NO_GRPC = r"""
import json, os, sys, tempfile
for blocked in ("torch", "grpc", "google.protobuf", "requests"):
    sys.modules[blocked] = None
from elastic_tpu_agent_torch.kube.client import KubeClient
from elastic_tpu_agent_torch.manager import ManagerOptions, NodeManager

class PodResources:
    def list(self):
        return type("R", (), {"pod_resources": []})()
    def get_allocatable_resources(self):
        return None

root = tempfile.mkdtemp(dir="/tmp")
os.makedirs(os.path.join(root, "dev"))
mgr = NodeManager(ManagerOptions(
    node_name="node-a", db_path=os.path.join(root, "meta.db"),
    operator_kind="stub:2", dev_root=os.path.join(root, "dev"),
    alloc_spec_dir=os.path.join(root, "alloc"),
    device_plugin_dir=os.path.join(root, "dp"),
    kube_client=KubeClient(sys.argv[1]), pod_resources_client=PodResources(),
    crash_loop_threshold=2))
mgr.run(block=True)          # ends when a critical subsystem trips
st = mgr.supervisor.status()
print(json.dumps([mgr.supervisor.critical_failed(),
                  {k: v["last_error"].split(":")[0] for k, v in st.items()
                   if v["last_error"]},
                  sorted(m for m in sys.modules if sys.modules[m] is not None
                         and m.split(".")[0] in ("torch", "grpc", "requests"))]))
mgr.stop()
"""


def test_a_node_without_grpc_trips_the_breaker():
    """No grpc: each device-plugin server's import fails, a critical
    crash; the breaker opens and run(block=True) returns."""
    api = FakeAPIServer()
    url = api.start()
    try:
        res = subprocess.run([sys.executable, "-c", NO_GRPC, url], cwd=ROOT,
                             env=_env(), capture_output=True, text=True,
                             timeout=60)
    finally:
        api.stop()
    assert res.returncode == 0, res.stderr
    failed, errors, leaked = json.loads(res.stdout.strip().splitlines()[-1])
    assert failed and set(failed) <= {
        "device-plugin:elasticgpu.io/gpu-core",
        "device-plugin:elasticgpu.io/gpu-memory"}
    # grpc None in sys.modules: ModuleNotFoundError, an ImportError
    assert set(errors.values()) == {"ModuleNotFoundError"}
    assert leaked == []


def test_the_agents_kube_client_reads_the_ports_apiserver_contract():
    """Both clients address the same paths: the agent's test apiserver
    answers the port's client as it answers the agent's."""
    api = FakeAPIServer()
    url = api.start()
    try:
        api.upsert_pod(make_pod("default", "p", NODE_NAME))
        assert KubeClient(url).get_pod("default", "p") == AgentKube(
            url).get_pod("default", "p")
    finally:
        api.stop()
