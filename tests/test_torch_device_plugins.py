"""The port's operators through the agent's unchanged plugins: the
``TPUSharePlugin`` harness of ``tests/test_plugins.py`` (fake kubelet over
real gRPC sockets, on-disk storage), with the port's ``StubOperator`` (4
H100s whose node minors are permuted against their indexes) in place of
the agent's, held against the same requests on the agent's 4-chip stub;
the manager's restart restore with the port operator handed in through
``ManagerOptions(operator=...)``; whole-card mode; the agent's sampler."""

import json
import os
import threading

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import rpc  # noqa: E402
from elastic_tpu_agent.common import (  # noqa: E402
    AnnotationAssumed,
    BytesPerMemoryUnit,
    ResourceTPUCore,
    ResourceTPUMemory,
    container_annotation,
)
from elastic_tpu_agent.kube.locator import KubeletDeviceLocator  # noqa: E402
from elastic_tpu_agent.plugins.base import PluginConfig  # noqa: E402
from elastic_tpu_agent.plugins.tpushare import (  # noqa: E402
    CORE_ENDPOINT,
    MEM_ENDPOINT,
    TPUSharePlugin,
    core_device_id,
    mem_device_id,
)
from elastic_tpu_agent.rpc import dp  # noqa: E402
from elastic_tpu_agent.sampler import UtilizationSampler  # noqa: E402
from elastic_tpu_agent.storage import Storage  # noqa: E402
from elastic_tpu_agent.tpu import StubOperator as AgentStub  # noqa: E402
from elastic_tpu_agent.types import Device  # noqa: E402
from elastic_tpu_agent_torch.device import (  # noqa: E402
    ExclusiveOperator,
    StubOperator,
)
from elastic_tpu_agent_torch.device.stub import (  # noqa: E402
    H100_SXM5_HBM_BYTES,
)

from fake_kubelet import FakeKubelet, FakeSitter  # noqa: E402

MINORS = [2, 0, 3, 1]       # card index -> /dev/nvidia<minor>
H100_UNITS = H100_SXM5_HBM_BYTES // BytesPerMemoryUnit


class Rig:
    """Fake kubelet + an operator + the agent's plugin bundle, wired as
    ``tests/test_plugins.py``'s harness wires them."""

    def __init__(self, root, make_operator):
        os.makedirs(root)
        self.dp_dir = os.path.join(root, "dp")
        pr_sock = os.path.join(root, "pr", "kubelet.sock")
        self.dev_root = os.path.join(root, "dev")
        os.makedirs(self.dev_root)
        self.alloc_dir = os.path.join(root, "alloc")
        self.kubelet = FakeKubelet(self.dp_dir, pr_sock)
        self.kubelet.start()
        self.sitter = FakeSitter()
        self.storage = Storage(os.path.join(root, "meta.db"))
        self.operator = make_operator(self.dev_root)
        pr_client = rpc.PodResourcesClient(pr_sock)
        self.plugin = TPUSharePlugin(PluginConfig(
            node_name="test-node", device_plugin_dir=self.dp_dir,
            pod_resources_socket=pr_sock, operator=self.operator,
            sitter=self.sitter, storage=self.storage,
            locator_factory=lambda res: KubeletDeviceLocator(res, pr_client),
            extra={"alloc_spec_dir": self.alloc_dir},
        ))
        self.stop = threading.Event()
        self.plugin.run(self.stop)
        assert self.kubelet.wait_registrations(2), "plugins did not register"

    def close(self):
        self.stop.set()
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        self.kubelet.stop()
        self.storage.close()

    def allocate(self, endpoint, ids):
        resp = self.kubelet.plugin_client(endpoint).allocate(ids)
        return resp.container_responses[0]

    def first_list(self, endpoint):
        stream = self.kubelet.plugin_client(endpoint).list_and_watch()
        return next(iter(stream)).devices


def port_stub(dev_root):
    return StubOperator(dev_root, num_chips=4, minors=MINORS)


@pytest.fixture()
def rig(tmp_path):
    r = Rig(str(tmp_path / "port"), port_stub)
    yield r
    r.close()


@pytest.fixture()
def pair(tmp_path):
    """The port's 4-card stub and the agent's 4-chip stub, side by side."""
    port = Rig(str(tmp_path / "port"), port_stub)
    agent = Rig(str(tmp_path / "agent"),
                lambda d: AgentStub(d, "v5litepod-4"))
    yield port, agent
    port.close()
    agent.close()


def assumed(chips):
    return {AnnotationAssumed: "true", container_annotation("main"): chips}


def test_both_resources_register(rig):
    regs = rig.kubelet.registrations
    assert {r.resource_name for r in regs} == {ResourceTPUCore,
                                               ResourceTPUMemory}
    assert all(r.options.pre_start_required for r in regs)


def test_core_advertises_100_units_per_card(rig):
    devices = rig.first_list(CORE_ENDPOINT)
    assert len(devices) == 4 * 100
    assert {core_device_id(c, u) for c in range(4) for u in (0, 99)} <= {
        d.ID for d in devices}
    assert all(d.health == rpc.HEALTHY for d in devices)


def test_memory_advertises_one_unit_per_mib_of_each_card(rig):
    devices = rig.first_list(MEM_ENDPOINT)
    assert len(devices) == 4 * H100_UNITS == 4 * 81559
    assert mem_device_id(3, H100_UNITS - 1) in {d.ID for d in devices}


def test_eight_cards_of_memory_units_exceed_one_grpc_message():
    """The agent's memory resource at one unit a MiB: one H100 SXM5 card
    is 81,559 devices, and 8 cards' ListAndWatch response runs past the
    agent's 16 MiB gRPC cap (rpc.MAX_MSG_BYTES), where 4 cards fit. The
    ids of cards 0-7 have one digit each, so the 8-card message is 8
    times one card's."""
    one = dp.ListAndWatchResponse(devices=[
        dp.Device(ID=mem_device_id(0, u), health=rpc.HEALTHY)
        for u in range(H100_UNITS)]).ByteSize()
    assert 4 * one < rpc.MAX_MSG_BYTES < 8 * one


def test_allocations_match_the_agents_stub(pair):
    """Fractional, 150-unit and quarter-card memory requests give the same
    chip sets, env keys and device specs on both stubs; the HBM limit is
    units x MiB on both and the fraction that of a quarter card."""
    port, agent = pair
    for ids in ([core_device_id(0, i) for i in range(50)],
                [core_device_id(0, i) for i in range(100)]
                + [core_device_id(1, i) for i in range(50)]):
        got, want = (r.allocate(CORE_ENDPOINT, ids) for r in pair)
        assert dict(got.envs) == dict(want.envs)
        assert [(d.host_path, d.container_path) for d in got.devices] == [
            (d.host_path, d.container_path) for d in want.devices]
    assert dict(got.envs)["TPU_VISIBLE_CHIPS"] == "0,1"
    assert dict(got.envs)["ELASTIC_TPU_CORE_UNITS"] == "150"
    agent_units = AgentStub("/nonexistent", "v5litepod-4").devices()[
        0].hbm_bytes // BytesPerMemoryUnit
    got = port.allocate(MEM_ENDPOINT, [mem_device_id(2, u)
                                       for u in range(H100_UNITS // 4)])
    want = agent.allocate(MEM_ENDPOINT, [mem_device_id(2, u)
                                         for u in range(agent_units // 4)])
    assert set(got.envs) == set(want.envs)
    assert got.envs["ELASTIC_TPU_HBM_LIMIT_BYTES"] == str(
        H100_UNITS // 4 * BytesPerMemoryUnit)
    assert want.envs["ELASTIC_TPU_HBM_LIMIT_BYTES"] == str(
        agent_units // 4 * BytesPerMemoryUnit)
    assert got.envs["ELASTIC_TPU_HBM_FRACTION"] == \
        want.envs["ELASTIC_TPU_HBM_FRACTION"] == "0.2500"
    assert len(got.devices) == len(want.devices) == 0


def test_prestart_links_target_minors(rig):
    rig.sitter.add_pod("default", "one", assumed("2"))
    ids = [core_device_id(2, i) for i in range(25)]
    rig.kubelet.kubelet_allocate_flow(CORE_ENDPOINT, "default", "one",
                                      "main", ResourceTPUCore, ids)
    h = Device(ids, ResourceTPUCore).hash
    link = os.path.join(rig.dev_root, f"elastic-tpu-{h}-0")
    assert os.readlink(link) == f"/dev/nvidia{MINORS[2]}"
    assert rig.operator.resolve(f"{h}-0") == 2
    with open(os.path.join(rig.alloc_dir, f"{h}.json")) as f:
        spec = json.load(f)
    assert spec["chip_indexes"] == [2]
    assert spec["device_paths"] == [f"/dev/nvidia{MINORS[2]}"]
    assert spec["env"]["ELASTIC_TPU_CORE_UNITS"] == "25"
    rec = rig.storage.load("default", "one").allocations["main"][
        ResourceTPUCore]
    assert rec.chip_indexes == [2] and rec.created_node_ids == [f"{h}-0"]

    rig.sitter.add_pod("default", "two", assumed("1,3"))
    ids = [core_device_id(1, i) for i in range(100)] + [
        core_device_id(3, i) for i in range(100)]
    rig.kubelet.kubelet_allocate_flow(CORE_ENDPOINT, "default", "two",
                                      "main", ResourceTPUCore, ids)
    h2 = Device(ids, ResourceTPUCore).hash
    assert [os.readlink(os.path.join(rig.dev_root, f"elastic-tpu-{h2}-{p}"))
            for p in (0, 1)] == [f"/dev/nvidia{MINORS[1]}",
                                 f"/dev/nvidia{MINORS[3]}"]
    assert [rig.operator.resolve(f"{h2}-{p}") for p in (0, 1)] == [1, 3]

    rig.sitter.remove_pod("default", "one")
    assert rig.plugin.gc_once() == 1
    assert not os.path.lexists(link)
    assert rig.storage.load("default", "one") is None
    assert sorted(rig.operator.list_links()) == [f"{h2}-0", f"{h2}-1"]


def test_unhealthy_card_is_advertised_unhealthy(rig):
    rig.operator.set_unhealthy([1])
    rig.plugin.health_once()
    health = {d.ID: d.health for d in rig.first_list(CORE_ENDPOINT)}
    assert health[core_device_id(1, 0)] == rpc.UNHEALTHY
    assert health[core_device_id(0, 0)] == rpc.HEALTHY


def test_exclusive_operator_hands_out_physical_nodes(tmp_path):
    r = Rig(str(tmp_path / "x"),
            lambda d: ExclusiveOperator(port_stub(d)))
    try:
        assert len(r.first_list(CORE_ENDPOINT)) == 4   # one id a card
        c = r.allocate(CORE_ENDPOINT, [core_device_id(2, 0)])
        assert [(d.host_path, d.container_path) for d in c.devices] == [
            (f"/dev/nvidia{MINORS[2]}", "/dev/accel0")]
        assert c.envs["ELASTIC_TPU_CORE_UNITS"] == "100"
        assert r.operator.check("anything") and r.operator.list_links() == []
    finally:
        r.close()


def test_agent_sampler_reads_the_port_stub(tmp_path):
    from elastic_tpu_agent.types import AllocationRecord

    op = port_stub(str(tmp_path / "dev"))
    storage = Storage(str(tmp_path / "meta.db"))
    try:
        ids = [core_device_id(1, i) for i in range(25)]
        info = storage.load_or_create("default", "p")
        info.set_allocation("main", AllocationRecord(
            device=Device(ids, ResourceTPUCore), chip_indexes=[1],
            created_node_ids=[]))
        storage.save(info)
        sampler = UtilizationSampler(op, storage=storage)
        op.set_utilization({1: 80.0}, hbm_used={1: 123})
        result = sampler.sample_once(now=1000.0)
        assert result["chips"][1] == {"duty_cycle_percent": 80.0,
                                      "hbm_used_bytes": 123}
        pod = result["pods"]["default/p"]
        assert (pod["granted_percent"], pod["used_percent"]) == (25.0, 80.0)
    finally:
        storage.close()


def test_manager_restores_links_of_a_port_operator(tmp_path):
    """``ManagerOptions(operator=...)`` takes the port's stub: after the
    agent restarts over a wiped /dev, its restore brings the link back,
    still aimed at the card's minor."""
    from fake_apiserver import make_pod
    from test_e2e import Cluster, wait_until

    from elastic_tpu_agent.manager import TPUManager

    op = port_stub(str(tmp_path / "dev"))
    c = Cluster(tmp_path, operator=op)
    c.start()
    try:
        c.apiserver.upsert_pod(make_pod(
            "default", "survivor", c.node, annotations=assumed("3"),
            containers=[{"name": "main"}]))
        assert wait_until(lambda: c.manager.sitter.get_pod(
            "default", "survivor") is not None)
        ids = [core_device_id(3, i) for i in range(100)]
        c.kubelet.kubelet_allocate_flow(CORE_ENDPOINT, "default", "survivor",
                                        "main", ResourceTPUCore, ids)
        link = os.path.join(c.opts.dev_root,
                            f"elastic-tpu-{Device(ids, ResourceTPUCore).hash}"
                            "-0")
        assert os.readlink(link) == f"/dev/nvidia{MINORS[3]}"
        c.manager.stop()
        os.unlink(link)
        mgr2 = TPUManager(c.opts)
        assert mgr2.operator is op
        mgr2.run(block=False)
        try:
            assert wait_until(lambda: os.path.islink(link), timeout=10.0)
            assert os.readlink(link) == f"/dev/nvidia{MINORS[3]}"
        finally:
            mgr2.stop()
    finally:
        c.kubelet.stop()
        c.apiserver.stop()
