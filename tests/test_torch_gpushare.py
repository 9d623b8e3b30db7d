"""The port's device plugins (``plugins/gpushare.py``) and container
injection (``nri/plugin.py``) against the agent's.

The port's ``GPUSharePlugin`` and the agent's unchanged ``TPUSharePlugin``
run side by side, each behind its own fake kubelet over real gRPC sockets,
with the agent's storage and locator and the port's ``StubOperator`` (4
H100s whose node minors are permuted against their indexes), and get the
same requests. They must agree on registrations, ListAndWatch ids and
health, preferred ids, bound card sets, storage records, spec files, Allocate
envs and GC, once the names are mapped (``gpu-`` ids and resources for
``tpu-`` ones, hence other hashes) and the keys that differ by design are
set aside: the visibility env (``CUDA_VISIBLE_DEVICES`` for the agent's
``TPU_VISIBLE_CHIPS``/``TPU_VISIBLE_DEVICES``) and the agent's
``ELASTIC_TPU_TRACE_ID`` (its tracer is not ported), and the port's
spec key ``control_paths``, which the agent's spec lacks. Then what differs:
``/dev/nvidia<minor>`` and the control nodes in both modes, never
``/dev/accel``; ``CUDA_VISIBLE_DEVICES`` by uuid; the NRI adjustment's
nodes, character devices only; the memory resource's message size.

Sockets live under a short ``/tmp`` directory: a unix socket path over 107
characters fails, and pytest's ``tmp_path`` can be that long.
"""

import json
import os
import shutil
import stat
import tempfile
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import rpc as agent_rpc  # noqa: E402
from elastic_tpu_agent.kube.locator import KubeletDeviceLocator  # noqa: E402
from elastic_tpu_agent.nri import plugin as agent_nri  # noqa: E402
from elastic_tpu_agent.plugins import tpushare  # noqa: E402
from elastic_tpu_agent.plugins.base import PluginConfig as AgentConfig  # noqa: E402
from elastic_tpu_agent.storage import Storage  # noqa: E402
from elastic_tpu_agent_torch import rpc  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    HEALTHY,
    UNHEALTHY,
    AllocSidecarSubdirs,
    AnnotationAssumed,
    BytesPerMemoryUnit,
    ResourceGPUCore,
    ResourceGPUMemory,
    container_annotation,
)
from elastic_tpu_agent_torch.device import (  # noqa: E402
    ExclusiveOperator,
    StubOperator,
)
from elastic_tpu_agent_torch.device.stub import (  # noqa: E402
    H100_SXM5_HBM_BYTES,
)
from elastic_tpu_agent_torch.gen import deviceplugin_pb2 as dp  # noqa: E402
from elastic_tpu_agent_torch.nri import plugin as nri  # noqa: E402
from elastic_tpu_agent_torch.plugins import gpushare  # noqa: E402
from elastic_tpu_agent_torch.plugins.base import (  # noqa: E402
    LocateError,
    PluginConfig,
)
from elastic_tpu_agent_torch.slices.packing import pick_chip_set  # noqa: E402
from elastic_tpu_agent_torch.types import Device  # noqa: E402
from elastic_tpu_agent_torch.workloads import contract  # noqa: E402

from fake_kubelet import FakeKubelet, FakeSitter  # noqa: E402

MINORS = [2, 0, 3, 1]       # card index -> /dev/nvidia<minor>
UNITS = H100_SXM5_HBM_BYTES // BytesPerMemoryUnit       # 81,559 a card
CONTROL = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
VISIBILITY = {"CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_CHIPS",
              "TPU_VISIBLE_DEVICES", "ELASTIC_TPU_TRACE_ID"}
# the port's spec names its cards' control nodes; the agent's has none
PORT_ONLY = {"control_paths"}
# the port's names -> the agent's
NAMES = (("elastic-gpushare-", "elastic-tpushare-"), ("gpu-core", "tpu-core"),
         ("gpu-mem", "tpu-mem"))


class Rig:
    """A fake kubelet, the agent's storage and locator, a port stub (or
    what ``wrap`` makes of it) and a plugin bundle (the port's or the
    agent's), wired as ``tests/test_plugins.py``'s harness wires them."""

    def __init__(self, root, port: bool, wrap=lambda op: op):
        self.port = port
        self.dp_dir = os.path.join(root, "dp")
        pr_sock = os.path.join(root, "pr.sock")
        self.dev_root = os.path.join(root, "dev")
        os.makedirs(self.dev_root)
        self.alloc_dir = os.path.join(root, "alloc")
        self.kubelet = FakeKubelet(self.dp_dir, pr_sock)
        self.kubelet.start()
        self.sitter = FakeSitter()
        self.storage = Storage(os.path.join(root, "meta.db"))
        self.stub = StubOperator(self.dev_root, num_chips=4, minors=MINORS)
        self.operator = wrap(self.stub)
        pr_client = agent_rpc.PodResourcesClient(pr_sock)
        wiring = dict(
            device_plugin_dir=self.dp_dir, operator=self.operator,
            sitter=self.sitter, storage=self.storage,
            locator_factory=lambda res: KubeletDeviceLocator(res, pr_client),
            extra={"alloc_spec_dir": self.alloc_dir},
        )
        config = PluginConfig(**wiring) if port else AgentConfig(
            node_name="test-node", pod_resources_socket=pr_sock, **wiring)
        self.plugin = (gpushare.GPUSharePlugin if port
                       else tpushare.TPUSharePlugin)(config)
        self.core_ep, self.mem_ep = (
            (gpushare.CORE_ENDPOINT, gpushare.MEM_ENDPOINT) if port
            else (tpushare.CORE_ENDPOINT, tpushare.MEM_ENDPOINT))
        self.core_res, self.mem_res = (
            (ResourceGPUCore, ResourceGPUMemory) if port
            else ("elasticgpu.io/tpu-core", "elasticgpu.io/tpu-memory"))
        self.stop = threading.Event()
        self.plugin.run(self.stop)
        assert self.kubelet.wait_registrations(2), "plugins did not register"

    def close(self):
        self.stop.set()
        self.plugin.core.stop_streams()
        self.plugin.memory.stop_streams()
        self.kubelet.stop()
        self.storage.close()

    def ids(self, kind, chip, units):
        fn = {("core", True): gpushare.core_device_id,
              ("mem", True): gpushare.mem_device_id,
              ("core", False): tpushare.core_device_id,
              ("mem", False): tpushare.mem_device_id}[kind, self.port]
        return [fn(chip, u) for u in units]

    def endpoint(self, kind):
        return self.core_ep if kind == "core" else self.mem_ep

    def resource(self, kind):
        return self.core_res if kind == "core" else self.mem_res

    def client(self, kind):
        """A kubelet's client of the plugin: the port's ``rpc`` for the
        port's plugin."""
        if not self.port:
            return self.kubelet.plugin_client(self.endpoint(kind))
        return rpc.DevicePluginClient(rpc.dial(os.path.join(
            self.dp_dir, self.endpoint(kind))))

    def first_list(self, kind):
        return [(d.ID, d.health) for d in next(iter(
            self.client(kind).list_and_watch())).devices]

    def bind(self, kind, pod, ids, chips=None):
        """Allocate + PreStart as the kubelet drives them; ``chips`` is
        the scheduler's annotation (None: no pod is added)."""
        if chips is not None:
            self.sitter.add_pod("default", pod, {
                AnnotationAssumed: "true",
                container_annotation("main"): chips})
        resp = self.kubelet.kubelet_allocate_flow(
            self.endpoint(kind), "default", pod, "main", self.resource(kind),
            ids)
        return resp.container_responses[0], Device(ids).hash

    def spec(self, h):
        with open(os.path.join(self.alloc_dir, f"{h}.json")) as f:
            return json.load(f)

    def links(self):
        return {i: self.stub.resolve(i) for i in self.stub.list_links()}


def short_root():
    return tempfile.mkdtemp(prefix="gs", dir="/tmp")


@pytest.fixture()
def rig():
    root = short_root()
    r = Rig(root, port=True)
    yield r
    r.close()
    shutil.rmtree(root, ignore_errors=True)


def agent_names(obj, hashes):
    """``obj`` (JSON-able) with the port's names and hashes mapped to the
    agent's, and the visibility and trace keys of every env and the
    port's own spec keys dropped."""
    text = json.dumps(obj)
    for port_h, agent_h in hashes.items():
        text = text.replace(port_h, agent_h)
    for mine, theirs in NAMES:
        text = text.replace(mine, theirs)
    out = json.loads(text)

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in VISIBILITY | PORT_ONLY}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(out)


# the scenario both bundles are driven through: (kind, pod, chip, units,
# annotation)
BINDS = [
    ("core", "a", 2, range(50), "2"),
    ("mem", "a", 2, range(UNITS // 4), None),     # pod a's sibling
    ("core", "b", 1, range(100), "3,1"),           # 100 ids of card 1,
    ("core", "c", 0, range(25), "0"),              # placed on cards 1, 3
]


@pytest.fixture(scope="module")
def scenario():
    """Both bundles through BINDS, a card turned unhealthy, then pod a
    deleted and the GC run; every reading kept for the tests below."""
    roots = [short_root(), short_root()]
    port, agent = Rig(roots[0], True), Rig(roots[1], False)
    out = dict(port=port, agent=agent, hashes={}, allocs=[], specs=[],
               regs=[[(r.version, r.resource_name, r.endpoint,
                       r.options.pre_start_required)
                      for r in x.kubelet.registrations]
                     for x in (port, agent)])
    try:
        out["lists"] = [[x.first_list(k) for k in ("core", "mem")]
                        for x in (port, agent)]
        out["preferred"] = {
            size: [list(x.client("core").get_preferred_allocation(
                [i for i, _ in x.first_list("core")], [], size)
                .container_responses[0].deviceIDs) for x in (port, agent)]
            for size in (50, 100, 150, 250)}
        for kind, pod, chip, units, chips in BINDS:
            got = [x.bind(kind, pod, x.ids(kind, chip, units), chips)
                   for x in (port, agent)]
            out["hashes"][got[0][1]] = got[1][1]
            out["allocs"].append([(dict(r.envs), [
                (d.container_path, d.host_path, d.permissions)
                for d in r.devices]) for r, _ in got])
        out["specs"] = [{h: x.spec(h) for h in hs} for x, hs in (
            (port, list(out["hashes"])), (agent, list(out["hashes"].values())))]
        out["records"] = [{k: json.loads(info.to_json())
                           for k, info in x.storage.items()}
                          for x in (port, agent)]
        out["links"] = [x.links() for x in (port, agent)]
        for x in (port, agent):
            x.stub.set_unhealthy([1])
            x.plugin.health_once()
        out["sick_lists"] = [x.first_list("core") for x in (port, agent)]
        for x in (port, agent):
            x.sitter.remove_pod("default", "a")
            out.setdefault("gc", []).append(x.plugin.gc_once())
        out["after_gc"] = [(x.links(), sorted(os.listdir(x.alloc_dir)),
                            sorted(k for k, _ in x.storage.items()))
                           for x in (port, agent)]
        yield out
    finally:
        for x, root in zip((port, agent), roots):
            x.close()
            shutil.rmtree(root, ignore_errors=True)


def test_registrations_match_the_agents(scenario):
    port, agent = scenario["regs"]
    assert sorted(agent_names(port, {})) == sorted(map(list, agent))
    assert {r[1] for r in port} == {ResourceGPUCore, ResourceGPUMemory}
    assert {r[2] for r in port} == {"elastic-gpushare-core.sock",
                                    "elastic-gpushare-mem.sock"}


@pytest.mark.parametrize("kind", ["core", "mem"])
def test_list_and_watch_matches_the_agents(scenario, kind):
    port, agent = (x[("core", "mem").index(kind)]
                   for x in scenario["lists"])
    assert agent_names(port, {}) == [list(d) for d in agent]
    assert len(port) == 4 * (100 if kind == "core" else UNITS)
    assert {h for _, h in port} == {HEALTHY}


def test_unhealthy_card_advertised_as_the_agent_does(scenario):
    port, agent = scenario["sick_lists"]
    assert agent_names(port, {}) == [list(d) for d in agent]
    sick = {i for i, h in port if h == UNHEALTHY}
    assert sick == {gpushare.core_device_id(1, u) for u in range(100)}


@pytest.mark.parametrize("size", [50, 100, 150, 250])
def test_preferred_ids_match_the_agents(scenario, size):
    port, agent = scenario["preferred"][size]
    assert agent_names(port, {}) == agent
    assert len(port) == size
    assert sorted({gpushare.chip_of_device_id(i) for i in port}) == list(
        range(-(-size // 100)))


def test_allocate_envs_match_the_agents_but_visibility(scenario):
    hashes = scenario["hashes"]
    for (kind, *_), (port, agent) in zip(BINDS, scenario["allocs"]):
        assert agent_names(port[0], hashes) == agent_names(agent[0], {})
        assert "CUDA_VISIBLE_DEVICES" not in port[0]   # shared: no card yet


def test_bound_cards_and_records_match_the_agents(scenario):
    port, agent = scenario["records"]
    assert agent_names(port, scenario["hashes"]) == agent
    assert port["default/b"]["allocations"]["main"][ResourceGPUCore][
        "chip_indexes"] == [1, 3]
    core_a, mem_a, core_b, core_c = scenario["hashes"]
    assert scenario["links"][0] == {
        f"{core_a}-0": 2, f"{mem_a}-0": 2, f"{core_b}-0": 1,
        f"{core_b}-1": 3, f"{core_c}-0": 0}
    assert agent_names(scenario["links"][0], scenario["hashes"]) == \
        scenario["links"][1]


def test_spec_files_match_the_agents_but_visibility(scenario):
    port, agent = scenario["specs"]
    hashes = scenario["hashes"]
    assert len(port) == len(agent) == 4
    assert agent_names(port, hashes) == agent_names(
        {hashes[h]: agent[hashes[h]] for h in port}, {})


def test_spec_names_bound_cards_by_minor_and_uuid(scenario):
    port = scenario["port"]
    uuids = {c.index: c.uuid for c in port.stub.devices()}
    core_a, mem_a, core_b, _ = port_specs = list(scenario["specs"][0].values())
    for spec, cards in ((core_a, [2]), (mem_a, [2]), (core_b, [1, 3])):
        assert spec["chip_indexes"] == cards
        assert spec["device_paths"] == [f"/dev/nvidia{MINORS[c]}"
                                        for c in cards]
        assert spec["env"]["CUDA_VISIBLE_DEVICES"] == ",".join(
            uuids[c] for c in cards)
        assert spec["control_paths"] == spec["own"]["control_paths"] == \
            CONTROL
    # the siblings' specs carry the union of both quotas
    assert core_a["env"] == mem_a["env"]
    assert core_a["env"]["ELASTIC_TPU_CORE_UNITS"] == "50"
    assert core_a["env"]["ELASTIC_TPU_HBM_LIMIT_BYTES"] == str(
        UNITS // 4 * BytesPerMemoryUnit)
    assert all("/dev/accel" not in json.dumps(s) for s in port_specs)


def test_shared_allocate_gives_control_nodes_only(scenario):
    for (kind, *_), (port, _agent) in zip(BINDS, scenario["allocs"]):
        want = [(p, p, "rwm") for p in CONTROL] if kind == "core" else []
        assert port[1] == want


def test_gc_matches_the_agents(scenario):
    port, agent = scenario["after_gc"]
    assert scenario["gc"] == [1, 1]
    assert agent_names(port, scenario["hashes"]) == [
        agent[0], agent[1], agent[2]]
    links, specs, records = port
    assert records == ["default/b", "default/c"]
    a_hashes = list(scenario["hashes"])[:2]
    assert not any(h in name for h in a_hashes for name in specs)
    assert not any(k.startswith(tuple(a_hashes)) for k in links)


def test_whole_card_mode_hands_out_the_cards_own_nodes():
    root = short_root()
    r = Rig(root, True, wrap=ExclusiveOperator)
    try:
        assert len(r.first_list("core")) == 4   # one id a card
        uuids = {c.index: c.uuid for c in r.stub.devices()}
        ids = [gpushare.core_device_id(2, 0), gpushare.core_device_id(0, 0)]
        resp, h = r.bind("core", "x", ids, chips="")
        nodes = [f"/dev/nvidia{MINORS[0]}", f"/dev/nvidia{MINORS[2]}"]
        assert [(d.container_path, d.host_path, d.permissions)
                for d in resp.devices] == [(p, p, "rwm")
                                           for p in nodes + CONTROL]
        assert resp.envs["CUDA_VISIBLE_DEVICES"] == \
            f"{uuids[0]},{uuids[2]}"
        assert resp.envs["ELASTIC_TPU_CORE_UNITS"] == "200"
        spec = r.spec(h)
        assert spec["device_paths"] == nodes
        assert spec["control_paths"] == CONTROL
        assert spec["env"]["CUDA_VISIBLE_DEVICES"] == \
            resp.envs["CUDA_VISIBLE_DEVICES"]
        assert r.stub.list_links() == []
    finally:
        r.close()
        shutil.rmtree(root, ignore_errors=True)


def char_stat(major, minor):
    return SimpleNamespace(st_mode=stat.S_IFCHR | 0o666,
                           st_rdev=os.makedev(major, minor))


def fake_stat(path):
    """stat of a fake host's character devices: nvidia<m> is 195:m, the
    control nodes 195:255 and 511:0/1; nothing else exists."""
    name = os.path.basename(path)
    if name.startswith("nvidia") and name[6:].isdigit():
        return char_stat(195, int(name[6:]))
    rdev = {"nvidiactl": (195, 255), "nvidia-uvm": (511, 0),
            "nvidia-uvm-tools": (511, 1)}.get(name)
    if rdev is None:
        raise FileNotFoundError(path)
    return char_stat(*rdev)


def test_adjustment_matches_the_agents_but_the_node_names(scenario):
    """On the same spec, the port's adjustment and the agent's carry the
    same env, mounts and annotations, and card devices of the same
    major:minor; the port names them ``/dev/nvidia<minor>`` and adds the
    control nodes."""
    spec = list(scenario["specs"][0].values())[2]       # pod b: cards 1, 3
    path = "/var/lib/elastic-tpu/alloc/x.json"
    got = nri.adjustment_from_spec(spec, stat_fn=fake_stat, spec_path=path)
    want = agent_nri.adjustment_from_spec(spec, stat_fn=fake_stat,
                                          spec_path=path)
    assert list(got.env) == list(want.env)
    assert list(got.mounts) == list(want.mounts)
    assert dict(got.annotations) == dict(want.annotations)
    cards = [(d.path, d.major, d.minor) for d in got.linux.devices]
    assert [(a, b) for _, a, b in cards[:2]] == [
        (d.major, d.minor) for d in want.linux.devices]
    assert [d.path for d in want.linux.devices] == ["/dev/accel0",
                                                    "/dev/accel1"]
    assert cards == [("/dev/nvidia0", 195, 0), ("/dev/nvidia1", 195, 1),
                     ("/dev/nvidiactl", 195, 255), ("/dev/nvidia-uvm", 511, 0),
                     ("/dev/nvidia-uvm-tools", 511, 1)]
    assert {kv.key: kv.value for kv in got.env}["CUDA_VISIBLE_DEVICES"] == \
        spec["env"]["CUDA_VISIBLE_DEVICES"]


def test_plain_adjustment_is_the_message():
    spec = {"hash": "abcd1234", "device_paths": ["/dev/nvidia3"],
            "control_paths": CONTROL, "env": {"B": "2", "A": "1"}}
    plain = nri.plain_adjustment(spec, stat_fn=fake_stat, dev_root="/host/dev",
                                 spec_path="/s.json")
    msg = nri.adjustment_from_spec(spec, stat_fn=fake_stat,
                                   dev_root="/host/dev", spec_path="/s.json")
    assert plain["env"] == [("A", "1"), ("B", "2")] == [
        (kv.key, kv.value) for kv in msg.env]
    assert [(d["path"], d["major"], d["minor"], d["file_mode"])
            for d in plain["devices"]] == [
        (d.path, d.major, d.minor, d.file_mode.value)
        for d in msg.linux.devices]
    assert [d["path"] for d in plain["devices"]] == ["/dev/nvidia3"] + \
        CONTROL
    assert plain["annotations"] == dict(msg.annotations)
    # no card named: no control node either
    assert nri.plain_adjustment({"hash": "h"}, stat_fn=fake_stat)[
        "devices"] == []


def test_adjustment_injects_character_devices_only(tmp_path):
    """On a host whose nodes are regular files (placeholders), the real
    ``stat`` refuses the card node and leaves the control nodes out; a
    control node at 0:0 is left out too, and the spec's control nodes
    are the only ones stat'ed."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidia3", "nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        (dev / name).write_text("")
    spec = {"hash": "h", "device_paths": ["/dev/nvidia3"],
            "control_paths": CONTROL}
    with pytest.raises(ValueError, match="/dev/nvidia3"):
        nri.plain_adjustment(spec, dev_root=str(dev))
    assert nri.plain_adjustment(dict(spec, device_paths=[]),
                                dev_root=str(dev))["devices"] == []

    def placeholder_tools(path):
        if path.endswith("nvidia-uvm-tools"):
            return char_stat(0, 0)
        return fake_stat(path)
    got = nri.plain_adjustment(spec, stat_fn=placeholder_tools)
    assert [(d["path"], d["major"], d["minor"]) for d in got["devices"]] == [
        ("/dev/nvidia3", 195, 3), ("/dev/nvidiactl", 195, 255),
        ("/dev/nvidia-uvm", 511, 0)]
    got = nri.plain_adjustment(dict(spec, control_paths=CONTROL[:1]),
                               stat_fn=fake_stat)
    assert [d["path"] for d in got["devices"]] == [
        "/dev/nvidia3", "/dev/nvidiactl"]


def test_hash_from_env_reads_both_spellings():
    assert nri.hash_from_env(["A=1", "GPU=g", "TPU=t"]) == "t"
    assert nri.hash_from_env(["GPU=g"]) == "g"
    assert nri.hash_from_env(["TPU=", "PATH=/bin"]) is None


@pytest.mark.parametrize("cards", [1, 4, 8])
def test_list_and_watch_message_size(cards, tmp_path):
    """The memory resource at one unit a MiB: one ListAndWatch response
    is 2,272,542 bytes a card, so 4 H100 SXM5 cards fit under the 16 MiB
    message cap (``rpc.MAX_MSG_BYTES``) and 8 do not."""
    op = StubOperator(str(tmp_path), num_chips=cards)
    plug = gpushare.GPUShareMemoryPlugin(PluginConfig(
        operator=op, locator_factory=lambda res: None))
    size = dp.ListAndWatchResponse(devices=[
        dp.Device(ID=i, health=h) for i, h in plug.device_list()]).ByteSize()
    assert size == cards * 2_272_542     # ids of cards 0-7: one digit each
    assert (size <= rpc.MAX_MSG_BYTES) == (cards <= 4)


def test_packing_policy():
    """The fewest cards; then the cards must-include ids sit on; then the
    lowest indexes (where the agent's ICI search took the fullest)."""
    free = {0: ["x"] * 30, 1: ["x"] * 100, 2: ["x"] * 100, 3: ["x"] * 60}
    assert pick_chip_set(free, 25) == [0]
    assert pick_chip_set(free, 25, {3}) == [3]
    assert pick_chip_set(free, 80) == [1]
    assert pick_chip_set(free, 150, {3}) == [3, 1]
    assert pick_chip_set(free, 150) == [1, 2]
    assert pick_chip_set(free, 400) == [0, 1, 2, 3]   # cannot be met


def test_bind_failures_leave_nothing(rig):
    rig.sitter.add_pod("default", "unknown-card", {
        AnnotationAssumed: "true", container_annotation("main"): "7"})
    rig.sitter.add_pod("default", "not-assumed", {
        container_annotation("main"): "0"})
    for pod, units, why in (("unknown-card", range(10), "not present"),
                            ("not-assumed", range(10, 20), "not assumed")):
        ids = rig.ids("core", 0, units)
        rig.kubelet.assign("default", pod, "main", ResourceGPUCore, ids)
        with pytest.raises(LocateError, match=why):
            rig.plugin.core.pre_start(ids)
    assert rig.stub.list_links() == []
    assert not os.path.exists(rig.alloc_dir) or os.listdir(
        rig.alloc_dir) == []
    assert list(rig.storage.items()) == []
    assert rig.storage.open_intents() == []


def test_sidecar_subdirs_are_the_runtimes():
    assert AllocSidecarSubdirs == (contract.UsageReportSubdir,
                                   contract.AckSubdir,
                                   contract.FlightSummarySubdir)


def test_failed_sibling_bind_restores_the_first_spec(rig):
    """A memory bind whose spec write fails after it merged itself into
    the core sibling's spec puts that spec back to its own content and
    leaves no link, record or intent of its own."""
    core_ids = rig.ids("core", 2, range(40))
    _, core_h = rig.bind("core", "p", core_ids, "2")
    before = rig.spec(core_h)
    mem_ids = rig.ids("mem", 2, range(1024))
    mem_h = Device(mem_ids).hash
    # the spec's temp file cannot be opened: the write fails after the
    # sibling was merged
    os.makedirs(os.path.join(rig.alloc_dir, f"{mem_h}.json.tmp"))
    rig.kubelet.assign("default", "p", "main", ResourceGPUMemory, mem_ids)
    with pytest.raises(IsADirectoryError):
        rig.plugin.memory.pre_start(mem_ids)
    after = rig.spec(core_h)
    assert after["env"] == before["env"] == before["own"]["env"]
    assert after["resources"] == [ResourceGPUCore]
    assert "ELASTIC_TPU_HBM_LIMIT_BYTES" not in after["env"]
    assert rig.stub.list_links() == [f"{core_h}-0"]
    assert list(rig.storage.load("default", "p").allocations["main"]) == [
        ResourceGPUCore]
    assert rig.storage.open_intents() == []


def test_cordon_advertises_every_card_unhealthy_without_counting_it(rig):
    core = rig.plugin.core
    core.set_cordoned(True)
    assert {h for _, h in rig.first_list("core")} == {UNHEALTHY}
    assert core.unhealthy_chips() == set() and core.cordoned
    core.set_cordoned(False)
    assert {h for _, h in rig.first_list("core")} == {HEALTHY}


def test_servers_register_again_after_a_kubelet_restart(rig):
    assert len(rig.kubelet.registrations) == 2
    rig.kubelet.restart_registration()
    assert rig.kubelet.wait_registrations(4, timeout=15.0)
    assert {r.resource_name for r in rig.kubelet.registrations[2:]} == {
        ResourceGPUCore, ResourceGPUMemory}
    assert len(rig.first_list("core")) == 400      # serving again


def test_registration_round_trip_over_the_ports_rpc():
    """The port's registration server and client (the kubelet's side and
    the plugin's) carry the v1beta1 request."""
    import grpc
    from concurrent import futures

    root = short_root()
    sock = os.path.join(root, "kubelet.sock")
    got = []
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
    rpc.add_registration_servicer(server, got.append)
    server.add_insecure_port(rpc.unix_target(sock))
    server.start()
    try:
        rpc.RegistrationClient(sock).register(
            endpoint=gpushare.CORE_ENDPOINT, resource_name=ResourceGPUCore)
    finally:
        server.stop(grace=0.2)
        shutil.rmtree(root, ignore_errors=True)
    assert [(r.version, r.endpoint, r.resource_name,
             r.options.pre_start_required) for r in got] == [
        ("v1beta1", "elastic-gpushare-core.sock", ResourceGPUCore, True)]


def test_pod_records_are_the_agents_json():
    from elastic_tpu_agent import types as agent_types
    from elastic_tpu_agent_torch import types as port_types

    def info(t):
        i = t.PodInfo("default", "p")
        i.set_allocation("main", t.AllocationRecord(
            t.Device(["gpu-core-1-0", "gpu-core-0-3"], ResourceGPUCore),
            [0, 1], ["h-0", "h-1"]))
        return i

    raw = info(port_types).to_json()
    assert raw == info(agent_types).to_json()
    back = port_types.PodInfo.from_json(raw)
    rec = back.allocations["main"][ResourceGPUCore]
    assert rec.device.ids == ("gpu-core-0-3", "gpu-core-1-0")
    assert rec.device.hash == agent_types.device_hash(rec.device.ids)
    assert back.to_json() == raw
