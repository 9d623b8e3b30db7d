"""The port's apiserver client, sitter and pod-resources locator
(``kube/``, ``rpc.PodResourcesClient``) against the agent's.

The port's ``KubeClient`` (standard library) and ``Sitter`` run beside the
agent's (``requests``) against one ``tests/fake_apiserver.py``, which
pages its lists two pods at a time: the same list, pagination, watch
adds, modifies and deletes, watch windows of one second that end and are
relisted, and a missing pod read from the apiserver must give the same
cache and the same ``on_delete`` sequence. The port's
``PodResourcesSnapshotSource`` and ``KubeletDeviceLocator`` run beside the
agent's against one ``tests/fake_kubelet.py`` over real gRPC, speaking v1
and v1alpha1: the same owners, the same assignments and the same
``LocateError`` messages.
"""

import json
import os
import shutil
import tempfile
import threading
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import rpc as agent_rpc  # noqa: E402
from elastic_tpu_agent.kube import client as agent_client  # noqa: E402
from elastic_tpu_agent.kube import locator as agent_locator  # noqa: E402
from elastic_tpu_agent.kube import sitter as agent_sitter  # noqa: E402
from elastic_tpu_agent.types import Device as AgentDevice  # noqa: E402
from elastic_tpu_agent_torch import rpc  # noqa: E402
from elastic_tpu_agent_torch.kube import client, locator, sitter  # noqa: E402
from elastic_tpu_agent_torch.types import Device  # noqa: E402

from fake_apiserver import FakeAPIServer, make_pod  # noqa: E402
from fake_kubelet import FakeKubelet  # noqa: E402

NODE = "node-a"


def wait_until(fn, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


# -- the apiserver client ------------------------------------------------------


@pytest.fixture()
def api():
    server = FakeAPIServer(max_page_size=2)
    url = server.start()
    for i in range(5):
        server.upsert_pod(make_pod("default", f"p{i}", NODE,
                                   annotations={"i": str(i)}))
    server.upsert_pod(make_pod("other", "elsewhere", "node-b"))
    server.add_node(NODE, {"a": "1"})
    yield server, url
    server.stop()


def clients(url):
    return client.KubeClient(url), agent_client.KubeClient(url)


def _names(pods):
    return sorted(p["metadata"]["name"] for p in pods)


def test_list_pods_paginates_as_the_agent(api):
    server, url = api
    port, agent = clients(url)
    (pi, prv), (ai, arv) = port.list_pods(NODE), agent.list_pods(NODE)
    assert pi == ai and prv == arv
    assert _names(pi) == [f"p{i}" for i in range(5)]
    assert server.request_counts["pod_list_pages"] >= 6   # 3 pages a list
    assert port.list_all_pods() == agent.list_all_pods()
    assert len(port.list_all_pods(page_limit=1)) == 6


def test_gets_and_404s_match_the_agents(api):
    _, url = api
    port, agent = clients(url)
    assert port.get_pod("default", "p1") == agent.get_pod("default", "p1")
    assert port.get_pod("default", "nope") is None
    assert agent.get_pod("default", "nope") is None
    assert port.get_node(NODE) == agent.get_node(NODE)
    assert port.get_node("missing") is None
    assert port.patch_pod_annotations("default", "nope", {"x": "1"}) is None


def test_patch_annotations_as_the_agent(api):
    server, url = api
    port, agent = clients(url)
    got = port.patch_pod_annotations("default", "p2", {"x": "1", "i": None})
    assert got["metadata"]["annotations"] == {"x": "1"}
    want = agent.patch_pod_annotations("default", "p3", {"x": "1", "i": None})
    assert want["metadata"]["annotations"] == {"x": "1"}


@pytest.mark.parametrize("call", ["get_pod", "list_pods", "get_node"])
def test_an_outage_is_a_kube_error_in_both(api, call):
    """A 503 is never a NotFound: GC must not read an outage as deletion."""
    server, url = api
    server.set_brownout(error_rate=1.0)
    args = {"get_pod": ("default", "p1"), "list_pods": (NODE,),
            "get_node": (NODE,)}[call]
    for c, err in zip(clients(url), (client.KubeError,
                                     agent_client.KubeError)):
        with pytest.raises(err, match="503"):
            getattr(c, call)(*args)


def test_watch_streams_the_events_of_the_node(api):
    server, url = api
    port, _ = clients(url)
    _, rv = port.list_pods(NODE)
    got = []

    def watch():
        for event in port.watch_pods(NODE, rv, timeout_s=1):
            got.append((event["type"], event["object"]["metadata"]["name"]))

    t = threading.Thread(target=watch)
    t.start()
    server.upsert_pod(make_pod("default", "new", NODE))
    server.upsert_pod(make_pod("other", "far", "node-b"))
    server.delete_pod("default", "p0")
    t.join(10)
    assert got == [("ADDED", "new"), ("DELETED", "p0")]


def test_kubeconfig_as_json_without_yaml(tmp_path, api, monkeypatch):
    """A JSON kubeconfig (kubectl reads it too) with a bearer token, read
    without PyYAML."""
    import sys

    _, url = api
    cfg = {"current-context": "c", "contexts": [
        {"name": "c", "context": {"cluster": "k", "user": "u"}}],
        "clusters": [{"name": "k", "cluster": {"server": url}}],
        "users": [{"name": "u", "user": {"token": "t0k"}}]}
    path = tmp_path / "kubeconfig"
    path.write_text(json.dumps(cfg))
    monkeypatch.setitem(sys.modules, "yaml", None)
    c = client.KubeClient.auto(str(path))
    assert c._headers["Authorization"] == "Bearer t0k"
    assert _names(c.list_pods(NODE)[0]) == [f"p{i}" for i in range(5)]


# -- the sitter ----------------------------------------------------------------


def test_sitter_cache_and_deletes_match_the_agents(api):
    """Both sitters on one apiserver with one-second watch windows; after
    each step both caches hold the same pods and both delete hooks saw the
    same pods, in the same order."""
    server, url = api
    port_c, agent_c = clients(url)
    deleted = {"port": [], "agent": []}
    stop = threading.Event()
    sitters = {
        "port": sitter.Sitter(port_c, NODE, relist_interval_s=1,
                              on_delete=lambda p: deleted["port"].append(
                                  p["metadata"]["name"])),
        "agent": agent_sitter.Sitter(agent_c, NODE, relist_interval_s=1,
                                     on_delete=lambda p: deleted[
                                         "agent"].append(
                                         p["metadata"]["name"])),
    }
    for s in sitters.values():
        s.start(stop)
    try:
        assert all(s.wait_synced(10) for s in sitters.values())

        def converged(names):
            return all(_names(s.pods()) == sorted(names)
                       for s in sitters.values())

        names = [f"p{i}" for i in range(5)]
        assert wait_until(lambda: converged(names))
        server.upsert_pod(make_pod("default", "p9", NODE))
        names.append("p9")
        assert wait_until(lambda: converged(names))
        server.upsert_pod(make_pod("default", "p1", NODE,
                                   annotations={"i": "changed"}))
        assert wait_until(lambda: all(
            s.get_pod("default", "p1")["metadata"]["annotations"] ==
            {"i": "changed"} for s in sitters.values()))
        server.delete_pod("default", "p0")
        names.remove("p0")
        assert wait_until(lambda: converged(names))
        # a watch window ends every second: wait out two relists
        time.sleep(2.5)
        server.delete_pod("default", "p2")
        names.remove("p2")
        assert wait_until(lambda: converged(names))
        assert wait_until(lambda: deleted["port"] == ["p0", "p2"]
                          and deleted["agent"] == ["p0", "p2"])
        caches = {k: {(p["metadata"]["namespace"], p["metadata"]["name"]):
                      p["metadata"]["annotations"] for p in s.pods()}
                  for k, s in sitters.items()}
        assert caches["port"] == caches["agent"]
        for s in sitters.values():
            assert s.get_pod_from_api("default", "gone") is None
            assert s.get_pod_from_api("default", "p3")["metadata"][
                "name"] == "p3"
            assert s.get_node_from_api(NODE)["metadata"]["name"] == NODE
            assert s.sync_age_s() is not None
    finally:
        stop.set()


def test_sitter_relist_fires_deletes_missed_while_down(api):
    """A pod deleted while no watch runs reaches on_delete at the next
    relist, in both."""
    server, url = api
    got = {}
    for side, c, mod in (("port", clients(url)[0], sitter),
                         ("agent", clients(url)[1], agent_sitter)):
        seen = []
        s = mod.Sitter(c, NODE, on_delete=lambda p, seen=seen: seen.append(
            p["metadata"]["name"]))
        s._relist()
        server.delete_pod("default", f"p{4 if side == 'port' else 3}")
        s._relist()
        got[side] = (seen, len(s.pods()))
    assert got == {"port": (["p4"], 4), "agent": (["p3"], 3)}


# -- the pod-resources locator -------------------------------------------------


@pytest.fixture(params=[("v1", "v1alpha1"), ("v1alpha1",)],
                ids=["v1", "v1alpha1"])
def kubelet(request):
    root = tempfile.mkdtemp(prefix="kb", dir="/tmp")
    k = FakeKubelet(os.path.join(root, "dp"), os.path.join(root, "pr.sock"))
    k.api_versions = request.param
    k.start()
    yield k
    k.stop()
    shutil.rmtree(root, ignore_errors=True)


CORE = "elasticgpu.io/gpu-core"
MEM = "elasticgpu.io/gpu-memory"


def _assign(k, split=False):
    k.split_device_entries = split
    k.assign("default", "a", "main", CORE, [f"gpu-core-0-{u}" for u in
                                             range(10)])
    k.assign("default", "a", "main", MEM, [f"gpu-mem-0-{u}" for u in
                                            range(7)])
    k.assign("default", "b", "side", CORE, [f"gpu-core-1-{u}" for u in
                                             range(3)])
    k.assign("other", "c", "main", "vendor.io/fpga", ["f0"])


def _owner(o):
    return (o.namespace, o.name, o.container)


@pytest.mark.parametrize("split", [False, True])
def test_locate_matches_the_agents(kubelet, split):
    _assign(kubelet, split)
    port_src = locator.PodResourcesSnapshotSource(
        rpc.PodResourcesClient(kubelet.pod_resources_socket))
    agent_src = agent_locator.PodResourcesSnapshotSource(
        agent_rpc.PodResourcesClient(kubelet.pod_resources_socket))
    cases = [(CORE, [f"gpu-core-0-{u}" for u in range(10)]),
             (MEM, [f"gpu-mem-0-{u}" for u in range(7)]),
             (CORE, [f"gpu-core-1-{u}" for u in range(3)]),
             (CORE, ["gpu-core-9-0"]),                       # nobody's
             (MEM, [f"gpu-core-0-{u}" for u in range(10)])]  # other resource
    for resource, ids in cases:
        got = []
        for loc, dev, err in (
                (locator.KubeletDeviceLocator(resource, source=port_src),
                 Device(ids, resource), locator.LocateError),
                (agent_locator.KubeletDeviceLocator(resource,
                                                    source=agent_src),
                 AgentDevice(ids, resource), agent_locator.LocateError)):
            try:
                got.append(_owner(loc.locate(dev)))
            except err as e:
                got.append(("LocateError", str(e)))
        assert got[0] == got[1], (resource, ids)
    pa, aa = port_src.assignments(), agent_src.assignments()
    assert {r: {h: (_owner(o), ids) for h, (o, ids) in by.items()}
            for r, by in pa.items()} == {
        r: {h: (_owner(o), ids) for h, (o, ids) in by.items()}
        for r, by in aa.items()}
    assert set(pa) == {CORE, MEM, "vendor.io/fpga"}
    assert port_src.stats()["lists_total"] >= 1


def test_a_dead_kubelet_is_a_locate_error_in_both():
    """No kubelet on the socket: both raise the same LocateError (each
    List is given 0.2 s to dial)."""
    root = tempfile.mkdtemp(prefix="kb", dir="/tmp")
    msgs = []
    try:
        for mod, r, dev in ((locator, rpc, Device),
                            (agent_locator, agent_rpc, AgentDevice)):
            class Quick(r.PodResourcesClient):
                def list(self, timeout_s=0.2):
                    return super().list(timeout_s)

            loc = mod.KubeletDeviceLocator(
                CORE, Quick(os.path.join(root, "pr.sock")))
            with pytest.raises(mod.LocateError) as e:
                loc.locate(dev(["gpu-core-0-0"], CORE))
            msgs.append(str(e.value).split(":")[0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert msgs[0] == msgs[1] == "pod-resources List failed"


def test_allocatable_and_the_negotiated_version(kubelet):
    kubelet.allocatable = {CORE: ["gpu-core-0-0", "gpu-core-1-0"]}
    port = rpc.PodResourcesClient(kubelet.pod_resources_socket)
    agent = agent_rpc.PodResourcesClient(kubelet.pod_resources_socket)
    got = [c.get_allocatable_resources() for c in (port, agent)]
    assert port.api_version == agent.api_version == kubelet.api_versions[0]
    if kubelet.api_versions[0] == "v1alpha1":
        assert got == [None, None]
    else:
        assert [[(d.resource_name, list(d.device_ids)) for d in g.devices]
                for g in got] == [[(CORE, ["gpu-core-0-0",
                                           "gpu-core-1-0"])]] * 2
    port.close()
    agent.close()


def test_prefetch_warms_the_shared_snapshot(kubelet):
    _assign(kubelet)
    src = locator.PodResourcesSnapshotSource(
        rpc.PodResourcesClient(kubelet.pod_resources_socket))
    core = locator.KubeletDeviceLocator(CORE, source=src)
    mem = locator.KubeletDeviceLocator(MEM, source=src)
    core.prefetch_async()
    assert wait_until(lambda: src.stats()["lists_total"] == 1)
    # both resources hit the one List's snapshot
    assert _owner(mem.locate(Device([f"gpu-mem-0-{u}" for u in range(7)],
                                    MEM))) == ("default", "a", "main")
    assert _owner(core.locate(Device([f"gpu-core-0-{u}" for u in range(10)],
                                     CORE))) == ("default", "a", "main")
    assert src.stats()["lists_total"] == 1
    assert core.stats()["cache_entries"] == 2
