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

The same flow runs again with the observability plane on both sides, with
every flag of the slice (the bus, a 0.005 s group-commit window, a sink
flush window, a timeline cap, Events, CRD, the profiler, a slow-span
threshold, an AgentMetrics): the restore reports, the pods' journals,
the Events' reasons, the ElasticTPU objects and the ported families'
samples equal the agent's. ``main()`` serves ``--metrics-port``, and
``node-doctor timeline`` and ``profile`` answer as the agent's.

The NRI flags parse as the agent's (``--nri-driver-lib`` is the port's
``--nri-libtpu``); the flags the port still lacks are pinned; with
``nri_socket`` the manager registers with a runtime stand-in
(``tests/torch_nri_runtime.py``), and with the eviction policy a card
flipped unhealthy evicts exactly the containers injected with it.
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

from prometheus_client import CollectorRegistry, generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from elastic_tpu_agent import cli as agent_cli  # noqa: E402
from elastic_tpu_agent import metrics as agent_metrics  # noqa: E402
from elastic_tpu_agent.kube.client import KubeClient as AgentKube  # noqa: E402
from elastic_tpu_agent_torch import cli, metrics, rpc  # noqa: E402
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
# the port's manager in the same configuration (its observability plane,
# on by default as the agent's, is held against the agent's below; the
# drain, as the agent's, is always on)
PORT_BIND_PATH = dict(enable_event_bus=False, enable_events=False,
                      enable_crd=False, enable_sampler=False,
                      enable_migration=False, enable_repartition=False)
# the observability plane on both sides, with every option of the slice
AGENT_OBS = dict(AGENT_BIND_PATH, enable_event_bus=True, enable_events=True,
                 enable_crd=True)
OBS_OPTIONS = dict(storage_batch_window_s=0.005, sink_flush_window_s=0.02,
                   timeline_cap=200, profile_hz=5.0, slow_span_ms=1000.0,
                   event_safety_net_factor=10.0)


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

    def __init__(self, port: bool, obs: bool = False):
        self.port = port
        self.root = pathlib.Path(tempfile.mkdtemp(prefix="mg", dir="/tmp"))
        self.names = Node.__new__(Node)       # ids and resources only
        self.names.port = port
        stub = StubOperator(str(self.root / "dev"), num_chips=4,
                            minors=MINORS)
        opts = AGENT_BIND_PATH if not port else PORT_BIND_PATH
        if obs:
            self.registry = CollectorRegistry()
            opts = dict(OBS_OPTIONS, **({} if port else AGENT_OBS),
                        metrics=(metrics if port else agent_metrics)
                        .AgentMetrics(registry=self.registry))
        if port:
            self.c = PortCluster(self.root, operator=stub, **opts)
        else:
            self.c = AgentCluster(self.root, operator=stub, **opts)
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
        # the boot pass's report, as restore() returns it: with the event
        # bus on, a targeted pass may follow it before the reconciler's
        # last report is read
        reports = []
        restore = mgr.restore
        mgr.restore = lambda: reports.append(restore()) or reports[-1]
        mgr.run(block=False)
        assert self.c.kubelet.wait_registrations(n + 2)
        return reports[0]

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


# the families the port feeds on this flow (the rest wait for their slices)
OBS_FAMILIES = ("elastic_tpu_allocate_seconds", "elastic_tpu_prestart_seconds",
                "elastic_tpu_bound_allocations", "elastic_tpu_gc_reclaimed",
                "elastic_tpu_restored_links", "elastic_tpu_chips",
                "elastic_tpu_chips_healthy", "elastic_tpu_reconcile_repairs",
                "elastic_tpu_build_info", "elastic_tpu_bind_inflight")
# what a reconciler event pass may add when it sees a kubelet assignment
# still unbound across two passes (a race, on either side)
RACY = {("bind_replay", None), ("reconcile_repair", "replayed_bind")}


def _samples(registry) -> dict:
    out = {}
    for fam in text_string_to_metric_families(
            generate_latest(registry).decode()):
        if fam.name in OBS_FAMILIES:
            for x in fam.samples:
                if x.name.endswith(("_created", "_bucket", "_sum")):
                    continue
                labels = ",".join(f"{k}={v}" for k, v in sorted(
                    x.labels.items()))
                out[f"{x.name}{{{labels}}}"] = x.value
    return out


def obs_flow(port: bool) -> dict:
    s = Side(port, obs=True)
    out = {}
    try:
        s.c.start()
        mgr = s.manager
        for pod, chips in (("train", "2"), ("web", "1")):
            s.add_pod(pod, chips)
        for k, p, c, u in BINDS:
            if p != "gone":
                s.bind(k, p, c, u)
        # a reboot wipes the links while no agent runs (a live one's
        # event passes would restore them at once)
        mgr.stop()
        for name in os.listdir(s.c.opts.dev_root):
            os.unlink(os.path.join(s.c.opts.dev_root, name))
        out["restore"] = s.restart()
        mgr = s.manager
        s.c.apiserver.delete_pod("default", "web")
        s.c.kubelet.unassign_pod("default", "web")
        assert wait_until(lambda: mgr.storage.load("default", "web") is None)
        assert wait_until(lambda: any(
            e["kind"] == "pod_reclaimed" for e in mgr.timeline.events(
                pod="default/web")))
        assert mgr.crd_recorder.flush(10) and mgr.events.flush(10)
        out["state"] = s.state()
        out["journals"] = {
            pod: sorted({(e["kind"], e["attrs"].get("class"))
                         for e in mgr.timeline.events(
                             pod=f"default/{pod}", causal=False)} - RACY)
            for pod in ("train", "web")}
        out["reasons"] = sorted(
            (e["reason"], e["involvedObject"]["name"])
            for e in s.c.apiserver.core_events)
        out["objects"] = sorted(
            (o["status"]["phase"], o["spec"]["claimRef"]["name"])
            for o in s.c.apiserver._crds.values())
        out["samples"] = _samples(s.registry)
        out["lag"] = mgr.lag_tracker.status()["classes"]
        out["healthz"] = mgr.supervisor.healthz()["critical_failed"]
        out["profile"] = mgr.profiler.status()["enabled"]
        mgr.stop()
        return out
    finally:
        s.close()


@pytest.fixture(scope="module")
def obs_flows():
    return {"port": obs_flow(True), "agent": obs_flow(False)}


def test_observability_flow_matches_the_agents(obs_flows):
    port, agent = obs_flows["port"], obs_flows["agent"]
    hashes = hash_map()
    rp = {k: v for k, v in port["restore"].items() if k != "duration_s"}
    assert rp == port_report(agent["restore"])
    assert to_agent(port["state"], hashes) == to_agent(agent["state"], {})
    for key in ("journals", "reasons", "objects", "healthz", "profile"):
        assert to_agent(port[key], hashes) == to_agent(agent[key], {}), key
    assert to_agent(port["samples"], hashes) == to_agent(
        agent["samples"], {})
    assert ("pod_reclaimed", None) in port["journals"]["web"]
    assert ("TPUBound", "train") in port["reasons"]
    assert ("Bound", "train") in port["objects"]
    assert port["samples"]["elastic_tpu_restored_links_total{}"] == 3
    # the port's GC reports the deletion's lag (the agent's GC does not)
    assert port["lag"]["reclaimed_pod"]["loops"] == ["gc"]
    assert port["lag"]["reclaimed_pod"]["triggers"]["event"]["count"] == 1


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
        "device-plugin:elasticgpu.io/gpu-memory", "drain", "gc", "goodput",
        "health", "reconciler", "sitter"]


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
    # --nri-driver-lib is the port's --nri-libtpu
    assert set(port) - set(agent) == {"nri_driver_lib"}
    differ = {k: (port[k], agent[k]) for k in port
              if k in agent and port[k] != agent[k]}
    # the port's operator is nvidia where the agent's is tpuvm, its plugin
    # kind gpushare where the agent's is tpushare
    assert differ == dict({} if argv else {"operator": ("nvidia", "tpuvm")},
                          plugin=("gpushare", "tpushare"))
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


OBS_FLAGS = ["--metrics-port", "0", "--metrics-addr", "0.0.0.0",
             "--no-events", "--no-crd", "--timeline-cap", "50",
             "--storage-batch-window", "0.005", "--sink-flush-window", "0.02",
             "--no-event-bus", "--event-safety-net-factor", "4",
             "--slow-span-ms", "300", "--profile-hz", "5"]


def test_observability_flags_match_the_agents():
    port = vars(cli.parse_args(OBS_FLAGS))
    agent = vars(agent_cli.parse_args(OBS_FLAGS))
    assert {k: (v, agent[k]) for k, v in port.items()
            if k in agent and v != agent[k]} == {
        "operator": ("nvidia", "tpuvm"), "plugin": ("gpushare", "tpushare")}
    opts = cli.options_from_args(cli.parse_args(OBS_FLAGS))
    assert (opts.enable_events, opts.enable_crd, opts.timeline_cap,
            opts.storage_batch_window_s, opts.sink_flush_window_s,
            opts.enable_event_bus, opts.event_safety_net_factor,
            opts.slow_span_ms, opts.profile_hz) == (
        False, False, 50, 0.005, 0.02, False, 4.0, 300.0, 5.0)
    defaults = cli.options_from_args(cli.parse_args([]))
    assert (defaults.enable_event_bus, defaults.enable_events,
            defaults.enable_crd, defaults.profile_hz,
            defaults.storage_batch_window_s) == (True, True, True, 0.0, 0.0)


NRI_FLAGS = ["--plugin", "gpushare", "--nri-socket", "/run/nri/nri.sock",
             "--nri-evict-on-chip-failure"]
# the agent's flag the port lacks: --nri-libtpu, whose counterpart is
# --nri-driver-lib
MISSING_FLAGS = {"nri_libtpu"}


def test_nri_flags_match_the_agents():
    port = vars(cli.parse_args(NRI_FLAGS))
    agent = vars(agent_cli.parse_args(NRI_FLAGS))
    assert {k: (v, agent[k]) for k, v in port.items()
            if k in agent and v != agent[k]} == {
        "operator": ("nvidia", "tpuvm")}
    opts = cli.options_from_args(cli.parse_args(NRI_FLAGS + [
        "--nri-driver-lib", "/lib/libcuda.so.1",
        "--nri-driver-lib", "/lib/libnvidia-ml.so.1"]))
    assert (opts.plugin_kind, opts.nri_socket, opts.nri_evict_on_chip_failure,
            opts.nri_driver_libs) == (
        "gpushare", "/run/nri/nri.sock", True,
        ["/lib/libcuda.so.1", "/lib/libnvidia-ml.so.1"])
    defaults = cli.options_from_args(cli.parse_args([]))
    assert (defaults.nri_socket, defaults.nri_driver_libs,
            defaults.nri_evict_on_chip_failure) == ("", [], False)


def test_evict_without_nri_socket_is_rejected_as_the_agent_rejects_it(
        capsys):
    for parse in (cli.parse_args, agent_cli.parse_args):
        with pytest.raises(SystemExit) as ei:
            parse(["--nri-evict-on-chip-failure"])
        assert ei.value.code == 2
        assert "requires --nri-socket" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.parse_args(["--plugin", "tpushare"])
    with pytest.raises(ValueError):
        NodeManager(ManagerOptions(plugin_kind="tpushare"))


HANDSHAKE_FLAGS = ["--sampler-period", "1", "--drain-deadline", "120",
                   "--drain-period", "0.5", "--preemption-notice", "20",
                   "--maintenance-poll-ttl", "5", "--migration-period",
                   "0.25"]


@pytest.mark.parametrize("argv", [HANDSHAKE_FLAGS,
                                  ["--no-sampler", "--no-migration"]],
                         ids=["periods", "off"])
def test_handshake_flags_match_the_agents(argv):
    port = vars(cli.parse_args(argv))
    agent = vars(agent_cli.parse_args(argv))
    assert {k: v for k, v in port.items() if k in agent and agent[k] != v
            } == {"operator": "nvidia", "plugin": "gpushare"}
    opts = cli.options_from_args(cli.parse_args(argv))
    assert (opts.enable_sampler, opts.sampler_period_s, opts.drain_deadline_s,
            opts.drain_period_s, opts.preemption_notice_s,
            opts.maintenance_poll_ttl_s, opts.enable_migration,
            opts.migration_period_s) == (
        (True, 1.0, 120.0, 0.5, 20.0, 5.0, True, 0.25)
        if argv is HANDSHAKE_FLAGS
        else (False, 10.0, 300.0, 2.0, 30.0, None, False, 2.0))


REPARTITION_FLAGS = ["--repartition-period", "0.5", "--qos-evict-after",
                     "75", "--goodput-period", "2.5"]
REPARTITION_OPTIONS = ("enable_repartition", "repartition_period_s",
                       "qos_evict_after_s", "goodput_period_s")


@pytest.mark.parametrize("argv,expect", [
    ([], (True, 10.0, 300.0, 10.0)),
    (REPARTITION_FLAGS, (True, 0.5, 75.0, 2.5)),
    (["--no-repartition"], (False, 10.0, 300.0, 10.0)),
], ids=["defaults", "periods", "off"])
def test_repartition_and_goodput_flags_match_the_agents(argv, expect):
    """The four flags parse as the agent's (defaults, types, the store_true
    switch) and set the options the agent's main sets from them, whose
    defaults are the agent's ManagerOptions'."""
    from elastic_tpu_agent.manager import ManagerOptions as AgentOptions

    port = vars(cli.parse_args(argv))
    agent = vars(agent_cli.parse_args(argv))
    flags = ("repartition_period", "no_repartition", "qos_evict_after",
             "goodput_period")
    assert {k: (port[k], type(port[k])) for k in flags} == {
        k: (agent[k], type(agent[k])) for k in flags}
    opts = cli.options_from_args(cli.parse_args(argv))
    assert tuple(getattr(opts, f) for f in REPARTITION_OPTIONS) == expect
    # the agent's main: enable_repartition=not args.no_repartition, the
    # periods passed through
    assert expect == (not agent["no_repartition"],
                      agent["repartition_period"], agent["qos_evict_after"],
                      agent["goodput_period"])
    assert tuple(getattr(ManagerOptions(), f) for f in REPARTITION_OPTIONS
                 ) == tuple(getattr(AgentOptions(), f)
                            for f in REPARTITION_OPTIONS)


def test_the_flags_the_port_lacks_are_those_of_later_items():
    port = vars(cli.parse_args([]))
    agent = vars(agent_cli.parse_args([]))
    assert set(agent) - set(port) == MISSING_FLAGS


def _nri_cluster(evict):
    from torch_nri_runtime import NRIRuntime

    root = pathlib.Path(tempfile.mkdtemp(prefix="mn", dir="/tmp"))
    rt = NRIRuntime(str(root / "nri.sock"))
    stub = StubOperator(str(root / "dev"), num_chips=4, minors=MINORS)
    c = PortCluster(root, operator=stub, nri_socket=rt.socket_path,
                    nri_evict_on_chip_failure=evict, **PORT_BIND_PATH)
    return root, rt, stub, c


def test_manager_runs_the_nri_plugin():
    """--nri-socket registers the NRI plugin beside the device-plugin
    servers, supervised as DEGRADED, and stop() ends its session."""
    from elastic_tpu_agent_torch.gen import nri_pb2 as pb
    from elastic_tpu_agent_torch.nri.plugin import event_mask

    root, rt, _, c = _nri_cluster(evict=False)
    try:
        c.start()
        rt.accept()
        assert rt.registered.wait(5.0)
        assert rt.configure().events == event_mask(pb.CREATE_CONTAINER,
                                                   pb.REMOVE_CONTAINER)
        status = c.manager.supervisor.status()
        assert status["nri"]["criticality"] == "degraded"
        assert c.manager.plugin.on_chips_failed is None
        c.manager.stop()
        assert wait_until(lambda: c.manager.nri_plugin._runtime is None)
    finally:
        c.stop()
        rt.close()
        shutil.rmtree(root, ignore_errors=True)


def test_a_card_flipped_unhealthy_evicts_exactly_its_containers():
    """With --nri-evict-on-chip-failure, the health poll's flip of card 1
    evicts the one container injected with it; its recovery lets a new
    container on it stay."""
    root, rt, stub, c = _nri_cluster(evict=True)
    try:
        c.start()
        # specs written after the boot pass, which sweeps unrecorded ones
        alloc = root / "alloc"
        alloc.mkdir(exist_ok=True)
        # the card nodes in the agent's view of the host's /dev
        os.symlink("/dev/null", root / "dev" / "nvidia91")
        for h, card in (("c1c1c1c1", 1), ("c2c2c2c2", 2)):
            (alloc / f"{h}.json").write_text(json.dumps({
                "hash": h, "chip_indexes": [card],
                "device_paths": ["/dev/nvidia91"], "control_paths": [],
                "env": {"CUDA_VISIBLE_DEVICES": f"GPU-{card}"}}))
        rt.accept()
        assert rt.registered.wait(5.0)
        rt.configure()
        for cid, h in (("on-1", "c1c1c1c1"), ("on-2", "c2c2c2c2")):
            resp = rt.create_container([f"GPU={h}"], container_id=cid)
            assert [d.path for d in resp.adjust.linux.devices] == [
                "/dev/nvidia91"]
        mgr = c.manager
        stub.set_unhealthy({1})
        assert mgr.plugin.health_once()
        assert rt.evicted_ids() == ["on-1"]
        assert "GPU card(s) 1" in rt.update_requests[0].evict[0].reason
        stub.set_unhealthy(set())
        assert mgr.plugin.health_once()
        assert mgr.nri_plugin._failed_chips == {}
        rt.create_container(["GPU=c1c1c1c1"], container_id="on-1b")
        assert mgr.nri_plugin._flush_evictions() == 0
        assert rt.evicted_ids() == ["on-1"]
    finally:
        c.stop()
        rt.close()
        shutil.rmtree(root, ignore_errors=True)


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _doctor(mod, argv):
    res = subprocess.run([sys.executable, "-m", mod, "node-doctor", *argv],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=60)
    return res.returncode, res.stdout, res.stderr


GOODPUT_ARGV = [[], ["--pod", "d/a"], ["--pod", "b"], ["--slice", "S"],
                ["--since", "15m"], ["--since", "1000000005"]]


@pytest.mark.parametrize("argv", GOODPUT_ARGV,
                         ids=["all", "pod", "bare", "slice", "relative",
                              "since"])
def test_node_doctor_goodput_prints_the_agents_block(tmp_path, argv):
    """``node-doctor goodput`` of both packages on one db (a pod bound,
    throttled and evicted, one live, the ledger's anchors journaled)
    prints the same JSON and exit code; a missing db exits 1 in both."""
    import contextlib
    import io

    from test_torch_goodput import _ledger_db

    db = str(tmp_path / "meta.db")
    _ledger_db(db)
    outs = []
    for main in (cli.doctor_main, agent_cli.doctor_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["goodput", "--db-file", db, *argv])
        outs.append((rc, json.loads(buf.getvalue())))
    if argv[-1:] == ["15m"]:
        # a relative bound is taken from each call's own wall clock
        since = [o[1]["entity"].pop("since") for o in outs]
        assert abs(since[0] - since[1]) < 60
    assert outs[0] == outs[1]
    rc, payload = outs[0]
    assert rc == 0 and payload["goodput"]["conservation_problems"] == []
    if not argv:
        assert sorted(payload["goodput"]["pods"]) == ["d/a", "d/b"]
    missing = ["goodput", "--db-file", str(tmp_path / "none.db")]
    assert cli.doctor_main(missing) == agent_cli.doctor_main(missing) == 1


def test_main_serves_metrics_and_node_doctor_reads_it():
    """``main()`` with --metrics-port and --profile-hz: /metrics lints
    clean, /healthz answers, the journal holds the boot; node-doctor
    profile reads the live agent, /debug/allocations holds the sampler's
    table with the drain, migration and repartition blocks,
    /debug/goodput answers the ledger, node-doctor's bundle of
    the live agent passes both packages' --validate, and node-doctor
    timeline reads its db after SIGTERM, each as the agent's subcommand
    does."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="cm", dir="/tmp"))
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
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    db = str(root / "meta.db")
    proc = subprocess.Popen(
        [sys.executable, "-m", "elastic_tpu_agent_torch.cli",
         "--node-name", NODE_NAME, "--db-file", db, "--kubeconf", str(kc),
         "--operator", "stub:2", "--dev-root", str(root / "dev"),
         "--device-plugin-dir", str(root / "dp"),
         "--pod-resources-socket", str(root / "pr.sock"),
         "--alloc-spec-dir", str(root / "alloc"),
         "--metrics-port", str(port), "--profile-hz", "20",
         "--storage-batch-window", "0.005"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert kubelet.wait_registrations(2, timeout=30), proc.stderr
        code, text = _get(base + "/metrics")
        assert code == 200 and metrics.lint_exposition(text) == []
        assert 'elastic_tpu_chips 2.0' in text
        assert _get(base + "/healthz")[0] == 200
        kinds = [e["kind"] for e in json.loads(
            _get(base + "/debug/timeline")[1])["events"]]
        assert kinds[0] == "agent_started"
        assert wait_until(lambda: json.loads(_get(
            base + "/debug/profile")[1])["samples_total"] > 0)
        rc, out, err = _doctor("elastic_tpu_agent_torch.cli",
                               ["profile", "--agent-url", base, "--top", "3"])
        assert rc == 0 and out.startswith("samples="), err
        rc_a, out_a, _ = _doctor("elastic_tpu_agent.cli",
                                 ["profile", "--agent-url", base, "--top",
                                  "3"])
        assert rc_a == 0 and out_a.startswith("samples=")
        # the sampler's table, and the doctor's bundle of the live agent,
        # valid by both packages' schema checks
        code, text = _get(base + "/debug/allocations")
        table = json.loads(text)
        assert code == 200 and [c["chip"] for c in table["chips"]] == [0, 1]
        assert table["drain"]["state"] == "active"
        assert table["migration"]["completed_total"] == 0
        assert table["repartition"]["enabled"] is True
        code, text = _get(base + "/debug/goodput")
        assert code == 200 and json.loads(text)["conservation_problems"] == []
        rc, out, err = _doctor("elastic_tpu_agent_torch.cli", [
            "--agent-url", base, "--operator", "stub:2", "--dev-root",
            str(root / "dev"), "--db-file", db, "--samples", "1",
            "--alloc-spec-dir", str(root / "alloc")])
        assert rc == 0, err
        (root / "bundle.json").write_text(out)
        bundle = json.loads(out)
        assert bundle["agent"]["reachable"] and bundle["allocations"][
            "chips"] and "drain" in bundle["agent"]["allocations"]
        for mod in ("elastic_tpu_agent_torch.cli", "elastic_tpu_agent.cli"):
            rc, _, err = _doctor(mod, ["--validate",
                                       str(root / "bundle.json")])
            assert rc == 0, err
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        argv = ["timeline", "--db-file", db, "--kind", "agent_started"]
        rc, out, err = _doctor("elastic_tpu_agent_torch.cli", argv)
        rc_a, out_a, err_a = _doctor("elastic_tpu_agent.cli", argv)
        assert rc == rc_a == 0, (err, err_a)
        assert json.loads(out) == json.loads(out_a)
        assert [e["kind"] for e in json.loads(out)["events"]] == [
            "agent_started"]
        assert _doctor("elastic_tpu_agent_torch.cli",
                       ["timeline", "--db-file", str(root / "no.db")])[0] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop()
        api.stop()
        shutil.rmtree(root, ignore_errors=True)
