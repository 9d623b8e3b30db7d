"""The port's NRI server (``elastic_tpu_agent_torch/nri``) against the
agent's, over the real wire protocol.

``tests/test_nri.py``'s cases carried over to the port's ``NRIPlugin`` with
the port's specs: the cards at ``/dev/nvidia<minor>``, the control nodes
the spec names (a gone one skipped), ``CUDA_VISIBLE_DEVICES`` by uuid and
the quota env. Each case runs against two runtimes: ``tests/
torch_nri_runtime.py``'s stand-in on the port's mux and ttrpc, and
``tests/test_nri.py``'s ``FakeNRIRuntime`` on the agent's, so the port's
plugin interoperates with the agent's transport. The agent's ``NRIPlugin``
is served by the port's stand-in, and both packages' ttrpc and mux frames
are byte-equal for the same messages. Sockets live under a short
``tempfile.mkdtemp(dir="/tmp")``: AF_UNIX paths end at 107 bytes.
"""

import json
import os
import shutil
import socket
import stat
import tempfile
import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent.nri import NRIPlugin as AgentNRIPlugin  # noqa: E402
from elastic_tpu_agent.nri import mux as agent_mux  # noqa: E402
from elastic_tpu_agent.nri import ttrpc as agent_ttrpc  # noqa: E402
from elastic_tpu_agent_torch.device import StubOperator  # noqa: E402
from elastic_tpu_agent_torch.gen import nri_pb2 as pb  # noqa: E402
from elastic_tpu_agent_torch.nri import (  # noqa: E402
    NRIPlugin,
    adjustment_from_spec,
    hash_from_env,
    plain_adjustment,
)
from elastic_tpu_agent_torch.nri import mux as port_mux  # noqa: E402
from elastic_tpu_agent_torch.nri import ttrpc as port_ttrpc  # noqa: E402
from elastic_tpu_agent_torch.nri.plugin import (  # noqa: E402
    PLUGIN_SERVICE,
    RUNTIME_SERVICE,
    SPEC_MOUNT_DEST,
    event_mask,
)

from test_nri import FakeNRIRuntime  # noqa: E402
from torch_nri_runtime import NRIRuntime  # noqa: E402


def char_stat(major, minor):
    return SimpleNamespace(st_mode=stat.S_IFCHR | 0o666,
                           st_rdev=os.makedev(major, minor))


def fake_stat_table(table):
    def stat_fn(path):
        if path not in table:
            raise FileNotFoundError(path)
        return table[path]

    return stat_fn


CONTROL = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
UUIDS = "GPU-11111111-2222-3333-4444-555555555502," \
        "GPU-11111111-2222-3333-4444-555555555503"
SPEC = {
    "hash": "ab12cd34",
    "resource": "elasticgpu.io/gpu-core",
    "namespace": "ml",
    "pod": "train",
    "container": "main",
    "chip_indexes": [2, 3],
    "device_paths": ["/dev/nvidia2", "/dev/nvidia3"],
    "control_paths": CONTROL,
    "env": {
        "CUDA_VISIBLE_DEVICES": UUIDS,
        "ELASTIC_TPU_CORE_UNITS": "200",
        "ELASTIC_TPU_HBM_LIMIT_BYTES": str(40 << 30),
    },
}
SPEC_B = dict(SPEC, hash="beef0002", pod="other", chip_indexes=[3],
              device_paths=["/dev/nvidia3"],
              env={"CUDA_VISIBLE_DEVICES": UUIDS.split(",")[1]})
# nvidia-uvm-tools is gone since discovery: skipped, as plain_adjustment
# skips it
DEV_TABLE = {
    "/dev/nvidia2": char_stat(195, 2),
    "/dev/nvidia3": char_stat(195, 3),
    "/dev/nvidiactl": char_stat(195, 255),
    "/dev/nvidia-uvm": char_stat(511, 0),
}
DRIVER_LIB = "/usr/lib/x86_64-linux-gnu/libcuda.so.1"


@pytest.fixture
def sock_dir():
    d = tempfile.mkdtemp(prefix="nri", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def alloc_dir(sock_dir):
    d = os.path.join(sock_dir, "alloc")
    os.makedirs(d)
    for spec in (SPEC, SPEC_B):
        with open(os.path.join(d, f"{spec['hash']}.json"), "w") as f:
            json.dump(spec, f)
    return d


def make_runtime(side, path):
    """The port's stand-in, or the agent's FakeNRIRuntime, with the ttrpc
    module its client speaks."""
    if side == "port":
        return NRIRuntime(path)
    rt = FakeNRIRuntime(path)
    rt.ttrpc = agent_ttrpc
    return rt


@pytest.fixture(params=["port", "agent"])
def runtime(request, sock_dir):
    rt = make_runtime(request.param, os.path.join(sock_dir, "nri.sock"))
    yield rt
    rt.close()


def start_plugin(runtime, alloc_dir, **kw):
    p = NRIPlugin(socket_path=runtime.socket_path, alloc_spec_dir=alloc_dir,
                  stat_fn=fake_stat_table(DEV_TABLE), **kw)
    p.RECONNECT_MIN_S = 0.05
    stop = threading.Event()
    thread = p.start(stop)
    runtime.accept()
    assert runtime.registered.wait(5.0)
    return p, stop, thread


@pytest.fixture
def plugin(runtime, alloc_dir):
    p, stop, thread = start_plugin(runtime, alloc_dir,
                                   driver_libs=[DRIVER_LIB])
    yield p
    stop.set()
    p.stop()
    thread.join(timeout=5.0)


def as_plain(adjust) -> dict:
    """A ContainerAdjustment as plain_adjustment's dict."""
    return dict(
        annotations=dict(adjust.annotations),
        devices=[dict(path=d.path, type=d.type, major=d.major, minor=d.minor,
                      file_mode=d.file_mode.value)
                 for d in adjust.linux.devices],
        env=[(kv.key, kv.value) for kv in adjust.env],
        mounts=[dict(destination=m.destination, type=m.type, source=m.source,
                     options=list(m.options)) for m in adjust.mounts])


def wait_for(fn, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not fn():
        time.sleep(0.02)
    return fn()


# -- the session --------------------------------------------------------------


def test_registration_identity(runtime, plugin):
    req = runtime.register_request
    assert (req.plugin_name, req.plugin_idx) == ("elastic-gpu", "10")


def test_configure_subscribes_create_and_remove(runtime, plugin):
    resp = runtime.configure()
    assert resp.events == event_mask(pb.CREATE_CONTAINER,
                                     pb.REMOVE_CONTAINER)
    assert plugin.configured.is_set()


def test_synchronize_reports_existing(runtime, plugin):
    existing = pb.Container(id="old", pod_sandbox_id="s0", name="old-gpu",
                            env=[f"GPU={SPEC['hash']}"])
    resp = runtime.synchronize(containers=[existing])
    assert list(resp.update) == []
    assert plugin.synchronized.is_set()
    assert plugin._bound_chips == {"old": {2, 3}}


def test_create_container_injects_the_plain_adjustment(
        runtime, plugin, alloc_dir):
    """The cards at their host names with the host's major:minor, the
    control nodes the spec names (a gone one left out), the spec's env,
    the spec and driver-library mounts: plain_adjustment's, with the
    driver libraries after it."""
    runtime.configure()
    resp = runtime.create_container([f"TPU={SPEC['hash']}", "FOO=bar"])
    adjust = resp.adjust
    spec_path = os.path.join(alloc_dir, f"{SPEC['hash']}.json")
    want = plain_adjustment(SPEC, stat_fn=fake_stat_table(DEV_TABLE),
                            spec_path=spec_path)
    want["mounts"].append(dict(destination=DRIVER_LIB, type="bind",
                               source=DRIVER_LIB,
                               options=["bind", "ro", "nosuid", "nodev"]))
    assert as_plain(adjust) == want
    assert [(d.path, d.major, d.minor) for d in adjust.linux.devices] == [
        ("/dev/nvidia2", 195, 2), ("/dev/nvidia3", 195, 3),
        ("/dev/nvidiactl", 195, 255), ("/dev/nvidia-uvm", 511, 0)]
    assert {kv.key: kv.value for kv in adjust.env} == SPEC["env"]
    mounts = {m.destination: m.source for m in adjust.mounts}
    assert mounts == {SPEC_MOUNT_DEST: spec_path, DRIVER_LIB: DRIVER_LIB}
    assert plugin.injected_count == 1


def test_create_container_gpu_compat_env(runtime, plugin):
    resp = runtime.create_container([f"GPU={SPEC['hash']}"])
    assert len(resp.adjust.linux.devices) == 4


def test_create_container_passthrough_without_hash(runtime, plugin):
    resp = runtime.create_container(["PATH=/usr/bin", "HOME=/root"])
    adj = resp.adjust
    assert (len(adj.linux.devices), len(adj.env), len(adj.mounts)) == (0, 0,
                                                                      0)
    assert plugin.injected_count == 0


def test_create_container_missing_spec_fails_closed(runtime, plugin):
    """A GPU container whose spec is gone must not start deviceless."""
    with pytest.raises(runtime.ttrpc.TtrpcError) as ei:
        runtime.create_container(["TPU=feedface"])
    assert "feedface" in ei.value.message


def test_hostile_hash_cannot_escape_alloc_dir(runtime, plugin, alloc_dir):
    with open(os.path.join(os.path.dirname(alloc_dir), "evil.json"),
              "w") as f:
        json.dump(SPEC, f)
    with pytest.raises(runtime.ttrpc.TtrpcError):
        runtime.create_container(["TPU=../evil"])


def test_a_card_node_that_is_no_device_fails_the_create(runtime, alloc_dir):
    p, stop, thread = start_plugin(runtime, alloc_dir)
    p._stat = fake_stat_table({"/dev/nvidia2": SimpleNamespace(
        st_mode=stat.S_IFREG | 0o644, st_rdev=0)})
    try:
        with pytest.raises(runtime.ttrpc.TtrpcError) as ei:
            runtime.create_container([f"TPU={SPEC['hash']}"])
        assert "not a character device" in ei.value.message
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)


def test_malformed_request_payload_keeps_session_alive(runtime, plugin):
    runtime.ttrpc.write_frame(runtime.mux.open(1), 99,
                              runtime.ttrpc.MESSAGE_TYPE_REQUEST,
                              b"\xff\xfe garbage")
    resp = runtime.create_container([f"TPU={SPEC['hash']}"])
    assert len(resp.adjust.linux.devices) == 4


def test_unexpected_response_frame_is_ignored(runtime, plugin):
    runtime.ttrpc.write_frame(runtime.mux.open(1), 7,
                              runtime.ttrpc.MESSAGE_TYPE_RESPONSE, b"")
    resp = runtime.create_container([f"TPU={SPEC['hash']}"])
    assert len(resp.adjust.linux.devices) == 4


def test_frame_for_unopened_mux_conn_is_dropped(runtime, plugin):
    runtime.mux._send(42, b"who dis")
    resp = runtime.create_container([f"TPU={SPEC['hash']}"])
    assert len(resp.adjust.linux.devices) == 4


def test_unknown_method_gets_unimplemented(runtime, plugin):
    with pytest.raises(runtime.ttrpc.TtrpcError) as ei:
        runtime.client.call(PLUGIN_SERVICE, "NoSuchMethod", pb.Empty(),
                            pb.Empty)
    assert ei.value.code == port_ttrpc.CODE_UNIMPLEMENTED


def test_reconnect_after_runtime_restart(runtime, alloc_dir):
    """containerd restarts: the plugin comes back and re-registers."""
    p, stop, thread = start_plugin(runtime, alloc_dir)
    try:
        runtime.mux.close()
        runtime.accept()
        assert runtime.registered.wait(5.0)
        resp = runtime.create_container([f"TPU={SPEC['hash']}"])
        assert len(resp.adjust.linux.devices) == 4
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)


def test_shutdown_then_reconnect(runtime, alloc_dir):
    p, stop, thread = start_plugin(runtime, alloc_dir)
    try:
        runtime.shutdown_plugin()
        runtime.accept()
        assert runtime.registered.wait(5.0)
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_stop_ends_run_and_closes_the_session(runtime, alloc_dir):
    p, stop, thread = start_plugin(runtime, alloc_dir)
    stop.set()
    p.stop()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert p._runtime is None and p._mux is None


# -- card-failure eviction ----------------------------------------------------


def test_evict_for_chips_targets_bound_containers(runtime, plugin):
    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="a")
    runtime.create_container([f"TPU={SPEC_B['hash']}"], container_id="b")
    runtime.create_container(["PATH=/bin"], container_id="c")  # not ours
    assert plugin.evict_for_chips({2}, reasons={2: "Xid 79"}) == 1
    evs = list(runtime.update_requests[0].evict)
    assert [e.container_id for e in evs] == ["a"]
    assert "GPU card(s) 2 (Xid 79) failed" in evs[0].reason
    # card 3 is in both, but "a" is already being evicted
    assert plugin.evict_for_chips({3}) == 1
    assert [e.container_id for e in runtime.update_requests[1].evict] == [
        "b"]


def test_removed_container_not_evicted(runtime, plugin):
    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="gone")
    runtime.state_change(pb.REMOVE_CONTAINER, "gone")
    assert plugin.evict_for_chips({2}) == 0
    assert runtime.update_requests == []


def test_evict_counts_runtime_failures(runtime, plugin):
    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="a")
    runtime.create_container([f"TPU={SPEC_B['hash']}"], container_id="b")
    runtime.fail_evictions = {"a"}
    assert plugin.evict_for_chips({3}) == 1


def test_evict_without_session_is_safe(alloc_dir, sock_dir):
    p = NRIPlugin(socket_path=os.path.join(sock_dir, "nowhere.sock"),
                  alloc_spec_dir=alloc_dir,
                  stat_fn=fake_stat_table(DEV_TABLE))
    p._bound_chips["x"] = {2}
    assert p.evict_for_chips({2}) == 0
    assert p._failed_chips == {2: "card unhealthy"}


def test_health_hook_drives_eviction(runtime, plugin, sock_dir):
    """The bundle's health poll: a card that goes unhealthy evicts the
    containers injected with it; its recovery clears the failed set, and a
    container created on it then stays."""
    from elastic_tpu_agent_torch.plugins.base import PluginConfig
    from elastic_tpu_agent_torch.plugins.gpushare import GPUSharePlugin
    from elastic_tpu_agent_torch.storage import Storage

    from fake_kubelet import FakeSitter

    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="victim")
    tmp = os.path.join(sock_dir, "share")
    os.makedirs(os.path.join(tmp, "dev"))
    op = StubOperator(os.path.join(tmp, "dev"), num_chips=4)
    storage = Storage(os.path.join(tmp, "meta.db"))
    share = GPUSharePlugin(PluginConfig(
        operator=op, sitter=FakeSitter(), storage=storage,
        locator_factory=lambda r: None,
        extra={"alloc_spec_dir": os.path.join(tmp, "alloc")}))
    share.on_chips_failed = plugin.evict_for_chips
    share.on_chips_recovered = plugin.clear_failed_chips
    try:
        share.health_once()
        assert runtime.update_requests == []
        op.set_unhealthy({2})
        assert share.health_once()
        assert [e.container_id for e in
                runtime.update_requests[0].evict] == ["victim"]
        assert plugin._failed_chips.keys() == {2}
        op.set_unhealthy(set())
        assert share.health_once()
        assert plugin._failed_chips == {}
        runtime.create_container([f"TPU={SPEC['hash']}"],
                                 container_id="after")
        assert plugin._flush_evictions() == 0
        assert len(runtime.update_requests) == 1
    finally:
        storage.close()


def test_a_failing_hook_does_not_wedge_the_health_poll(sock_dir):
    from elastic_tpu_agent_torch.plugins.base import PluginConfig
    from elastic_tpu_agent_torch.plugins.gpushare import GPUSharePlugin
    from elastic_tpu_agent_torch.storage import Storage

    from fake_kubelet import FakeSitter

    os.makedirs(os.path.join(sock_dir, "dev"))
    op = StubOperator(os.path.join(sock_dir, "dev"), num_chips=2)
    storage = Storage(os.path.join(sock_dir, "meta.db"))
    share = GPUSharePlugin(PluginConfig(
        operator=op, sitter=FakeSitter(), storage=storage,
        locator_factory=lambda r: None,
        extra={"alloc_spec_dir": os.path.join(sock_dir, "alloc")}))
    seen = []

    def boom(chips, reasons):
        seen.append((chips, reasons))
        raise RuntimeError("policy down")

    share.on_chips_failed = boom
    try:
        op.set_unhealthy({1})
        assert share.health_once()
        assert seen and seen[0][0] == {1}
        assert share.core.unhealthy_chips() == {1}
    finally:
        storage.close()


def test_synchronize_rebuilds_tracking_from_snapshot(runtime, plugin):
    runtime.configure()
    plugin._bound_chips["stale-id"] = {2}
    runtime.synchronize(containers=[pb.Container(
        id="old-ctr", pod_sandbox_id="s0", name="oldgpu",
        env=[f"TPU={SPEC['hash']}"])])
    assert plugin._bound_chips == {"old-ctr": {2, 3}}
    assert plugin.evict_for_chips({2}) == 1
    assert runtime.update_requests[0].evict[0].container_id == "old-ctr"


def test_pending_eviction_retries_after_reconnect(runtime, alloc_dir):
    """A card failure while the session is down parks the eviction; the
    next session's Synchronize retries it off the serve thread."""
    p, stop, thread = start_plugin(runtime, alloc_dir)
    try:
        runtime.configure()
        runtime.create_container([f"TPU={SPEC['hash']}"],
                                 container_id="v1")
        runtime.mux.close()
        assert wait_for(lambda: p._runtime is None)
        assert p.evict_for_chips({2}, {2: "node missing"}) == 0
        runtime.accept()
        assert runtime.registered.wait(5.0)
        runtime.configure()
        runtime.synchronize(containers=[pb.Container(
            id="v1", name="m", env=[f"TPU={SPEC['hash']}"])])
        assert wait_for(lambda: runtime.update_requests)
        ev = runtime.update_requests[0].evict[0]
        assert ev.container_id == "v1" and "node missing" in ev.reason
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)


def test_recovery_clears_sticky_failed_chips(runtime, plugin):
    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="a")
    assert plugin.evict_for_chips({2}) == 1
    plugin.clear_failed_chips({2})
    assert plugin._failed_chips == {}
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="a2")
    assert plugin._flush_evictions() == 0
    assert len(runtime.update_requests) == 1


def test_container_born_on_failed_chip_is_evicted(runtime, plugin):
    runtime.configure()
    assert plugin.evict_for_chips({2}, {2: "died early"}) == 0
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="late")
    assert wait_for(lambda: runtime.update_requests)
    assert runtime.update_requests[0].evict[0].container_id == "late"


def test_remove_prunes_evicted_set(runtime, plugin):
    runtime.configure()
    runtime.create_container([f"TPU={SPEC['hash']}"], container_id="x")
    assert plugin.evict_for_chips({2}) == 1
    assert "x" in plugin._evicted
    runtime.state_change(pb.REMOVE_CONTAINER, "x")
    assert "x" not in plugin._evicted


def test_nri_churn_soak(runtime, plugin):
    """Create/remove churn: the tracking stays exact, the session answers,
    and an eviction sees only the live containers."""
    runtime.configure()
    for i in range(60):
        cid = f"churn-{i}"
        resp = runtime.create_container([f"TPU={SPEC['hash']}"],
                                        container_id=cid)
        assert len(resp.adjust.linux.devices) == 4
        if i % 2 == 0:
            runtime.state_change(pb.REMOVE_CONTAINER, cid)
    live = {f"churn-{i}" for i in range(60) if i % 2 == 1}
    assert set(plugin._bound_chips) == live
    assert plugin.evict_for_chips({2}) == len(live)
    assert {e.container_id for e in
            runtime.update_requests[-1].evict} == live


def test_metrics_count_injections(runtime, alloc_dir):
    from prometheus_client import CollectorRegistry

    from elastic_tpu_agent_torch.metrics import AgentMetrics

    m = AgentMetrics(registry=CollectorRegistry())
    p, stop, thread = start_plugin(runtime, alloc_dir, metrics=m)
    try:
        runtime.create_container([f"TPU={SPEC['hash']}"])
        runtime.create_container(["PATH=/bin"], container_id="c2")
        assert m.nri_injections._value.get() == 1
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)


# -- the pure adjustment ------------------------------------------------------


def test_adjustment_dev_root_translation():
    seen = []

    def spy(path):
        seen.append(path)
        return char_stat(195, 0)

    adjust = adjustment_from_spec(
        {"hash": "h", "device_paths": ["/dev/nvidia0"],
         "control_paths": ["/dev/nvidiactl"], "env": {}},
        stat_fn=spy, dev_root="/host/dev")
    assert seen == ["/host/dev/nvidia0", "/host/dev/nvidiactl"]
    assert [d.path for d in adjust.linux.devices] == ["/dev/nvidia0",
                                                      "/dev/nvidiactl"]


def test_adjustment_mounts_only_what_is_asked():
    adjust = adjustment_from_spec(
        {"hash": "h", "device_paths": [], "env": {"A": "1"}},
        stat_fn=fake_stat_table({}))
    assert len(adjust.mounts) == 0
    assert [kv.key for kv in adjust.env] == ["A"]
    adjust = adjustment_from_spec(
        {"hash": "h", "device_paths": [], "env": {}},
        stat_fn=fake_stat_table({}), spec_path="/s.json",
        driver_libs=["/lib/a.so", "/lib/b.so"])
    assert [(m.destination, m.source, list(m.options))
            for m in adjust.mounts] == [
        (SPEC_MOUNT_DEST, "/s.json", ["bind", "ro", "nosuid", "nodev"]),
        ("/lib/a.so", "/lib/a.so", ["bind", "ro", "nosuid", "nodev"]),
        ("/lib/b.so", "/lib/b.so", ["bind", "ro", "nosuid", "nodev"])]


def test_hash_from_env_prefers_tpu_and_skips_empty():
    assert hash_from_env(["GPU=g", "TPU=t"]) == "t"
    assert hash_from_env(["TPU=", "GPU=g"]) == "g"
    assert hash_from_env(["TPUX=t"]) is None
    assert hash_from_env([]) is None


def test_spec_mount_source_uses_host_namespace_path(sock_dir):
    """runc resolves Mount.source in the host's mount namespace: the
    host-side alloc dir, not the agent's /host view."""
    view = os.path.join(sock_dir, "host", "var", "lib", "elastic-tpu",
                        "alloc")
    os.makedirs(view)
    with open(os.path.join(view, f"{SPEC['hash']}.json"), "w") as f:
        json.dump(SPEC, f)
    p = NRIPlugin(socket_path="unused", alloc_spec_dir=view,
                  host_alloc_dir="/var/lib/elastic-tpu/alloc",
                  stat_fn=fake_stat_table(DEV_TABLE))
    resp = p._on_create_container(pb.CreateContainerRequest(
        pod=pb.PodSandbox(name="t", namespace="ns"),
        container=pb.Container(id="c", env=[f"TPU={SPEC['hash']}"])))
    mounts = {m.destination: m.source for m in resp.adjust.mounts}
    assert mounts[SPEC_MOUNT_DEST] == \
        f"/var/lib/elastic-tpu/alloc/{SPEC['hash']}.json"


# -- the agent's plugin on the port's stand-in --------------------------------


AGENT_SPEC = {
    "hash": "ab12cd34", "chip_indexes": [2, 3],
    "device_paths": ["/dev/accel2", "/dev/accel3"],
    "env": {"TPU_VISIBLE_CHIPS": "0,1"},
}


def test_the_agents_plugin_is_served_by_the_ports_runtime(sock_dir):
    alloc = os.path.join(sock_dir, "alloc-agent")
    os.makedirs(alloc)
    with open(os.path.join(alloc, "ab12cd34.json"), "w") as f:
        json.dump(AGENT_SPEC, f)
    rt = NRIRuntime(os.path.join(sock_dir, "a.sock"))
    p = AgentNRIPlugin(socket_path=rt.socket_path, alloc_spec_dir=alloc,
                       stat_fn=fake_stat_table({
                           "/dev/accel2": char_stat(120, 2),
                           "/dev/accel3": char_stat(120, 3)}))
    stop = threading.Event()
    thread = p.start(stop)
    try:
        rt.accept()
        assert rt.registered.wait(5.0)
        assert rt.register_request.plugin_name == "elastic-tpu"
        assert rt.configure().events == event_mask(pb.CREATE_CONTAINER,
                                                   pb.REMOVE_CONTAINER)
        resp = rt.create_container(["TPU=ab12cd34"], container_id="a")
        assert [(d.path, d.major, d.minor) for d in
                resp.adjust.linux.devices] == [("/dev/accel0", 120, 2),
                                               ("/dev/accel1", 120, 3)]
        assert p.evict_for_chips({3}) == 1
        assert rt.evicted_ids() == ["a"]
        with pytest.raises(port_ttrpc.TtrpcError):
            rt.create_container(["TPU=feedface"])
    finally:
        stop.set()
        p.stop()
        thread.join(timeout=5.0)
        rt.close()


# -- the wire: both packages' frames are the same bytes ----------------------


class Tape:
    """A channel that records what is sent and replays ``replies``, then
    ends with ``closed`` (the ttrpc module's ChannelClosed)."""

    def __init__(self, replies=b"", closed=port_ttrpc.ChannelClosed):
        self.sent = b""
        self._in = replies
        self._closed = closed

    def sendall(self, data):
        self.sent += data

    def recv_exact(self, n, timeout=None):  # noqa: ARG002
        if len(self._in) < n:
            raise self._closed("tape ended")
        out, self._in = self._in[:n], self._in[n:]
        return out

    def close(self):
        pass


MESSAGES = [
    ("RegisterPlugin", pb.RegisterPluginRequest(plugin_name="elastic-gpu",
                                                plugin_idx="10"), pb.Empty),
    ("Configure", pb.ConfigureRequest(runtime_name="containerd",
                                      runtime_version="v2"),
     pb.ConfigureResponse),
    ("CreateContainer", pb.CreateContainerRequest(
        pod=pb.PodSandbox(id="s", name="p", namespace="n"),
        container=pb.Container(id="c", env=["GPU=ab12cd34"])),
     pb.CreateContainerResponse),
    ("UpdateContainers", pb.UpdateContainersRequest(evict=[
        pb.ContainerEviction(container_id="c", reason="card 0 failed")]),
     pb.UpdateContainersResponse),
]


@pytest.mark.parametrize("method,request_msg,response_cls", MESSAGES,
                         ids=[m[0] for m in MESSAGES])
def test_ttrpc_frames_are_the_agents(method, request_msg, response_cls):
    """A call's request frame (timeout included), and a server's response
    frame to it, are byte-equal across the two packages."""
    reply = Tape()
    port_ttrpc.write_frame(reply, 1, port_ttrpc.MESSAGE_TYPE_RESPONSE,
                           port_ttrpc.ttrpc_pb2.Response(
                               payload=response_cls().SerializeToString()
                           ).SerializeToString())
    sent = {}
    for name, mod in (("port", port_ttrpc), ("agent", agent_ttrpc)):
        tape = Tape(reply.sent)
        mod.Client(tape).call(RUNTIME_SERVICE, method, request_msg,
                              response_cls, timeout_s=2.5)
        sent[name] = tape.sent
    assert sent["port"] == sent["agent"]
    responses = {}
    for name, mod in (("port", port_ttrpc), ("agent", agent_ttrpc)):
        tape = Tape(sent["port"], closed=mod.ChannelClosed)
        server = mod.Server(tape)
        server.register(RUNTIME_SERVICE, method, type(request_msg),
                        lambda req: response_cls())
        server.serve_forever()          # returns when the tape ends
        responses[name] = tape.sent
    assert responses["port"] == responses["agent"] and responses["port"]


def test_mux_frames_are_the_agents():
    got = {}
    for name, mod in (("port", port_mux), ("agent", agent_mux)):
        a, b = socket.socketpair()
        m = mod.Mux(a)
        for conn, data in ((1, b"plugin"), (2, b""), (2, b"x" * 1000)):
            m._send(conn, data)
        m.close()
        chunks = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            chunks += chunk
        b.close()
        got[name] = chunks
    assert got["port"] == got["agent"]
    assert got["port"][:14] == b"\x00\x00\x00\x01\x00\x00\x00\x06plugin"


def test_an_oversized_mux_frame_closes_the_connection():
    a, b = socket.socketpair()
    m = port_mux.Mux(a)
    ch = m.open(port_mux.PLUGIN_SERVICE_CONN)
    m.start()
    b.sendall((1).to_bytes(4, "big") + ((1 << 24) + 1).to_bytes(4, "big"))
    with pytest.raises(port_ttrpc.ChannelClosed):
        ch.recv_exact(1, timeout=5.0)
    assert m.closed
    b.close()
