"""A multi-host slice on the port's agents (the counterpart of
``tests/test_multihost.py``).

Four port ``NodeManager``s, one a simulated H100 host, each with its own
``tests/fake_kubelet.py`` and a 4-card ``StubOperator`` that knows its
worker id among the four hosts, against ONE ``tests/fake_apiserver.py``.
One pod lands on each host and is bound over gRPC. Every agent derives the
member's slice env on its own, from its host facts and the pod's
annotations, with no agent-to-agent coordination: the worker ids must be
distinct and the host lists, types, slice names and epochs identical, as
the agent's ``slice_env_for_pod`` derives them from the same facts. A
slice annotated with its own id and a shuffled host list then loses a
member: each survivor's reconciler re-forms its member (two passes), and
the three agree on one world of three at epoch 1.

The sockets and the agents' state sit under a short
``tempfile.mkdtemp(dir="/tmp")``: pytest's ``tmp_path`` can pass the
107-character limit of a unix socket's path.
"""

import json
import os
import random
import shutil
import tempfile
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import slice_env as agent_env  # noqa: E402
from elastic_tpu_agent_torch import rpc  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    AnnotationAssumed,
    AnnotationSliceID,
    AnnotationSliceName,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
    EnvSliceEpoch,
    EnvSliceName,
    ResourceGPUCore,
    container_annotation,
)
from elastic_tpu_agent_torch.device import StubOperator  # noqa: E402
from elastic_tpu_agent_torch.kube.client import KubeClient  # noqa: E402
from elastic_tpu_agent_torch.manager import (  # noqa: E402
    ManagerOptions,
    NodeManager,
)
from elastic_tpu_agent_torch.plugins.gpushare import (  # noqa: E402
    CORE_ENDPOINT,
    core_device_id,
)
from elastic_tpu_agent_torch.types import Device  # noqa: E402

from fake_apiserver import FakeAPIServer, make_pod  # noqa: E402
from fake_kubelet import FakeKubelet  # noqa: E402

N_HOSTS = 4
HOSTNAMES = [f"gpu-host-{i}" for i in range(N_HOSTS)]
SLICE_TYPE = "h100-sxm5-32"      # 32 cards, 8 a host: 4 hosts
# the agent in its bind-path configuration, the reconciler driven by hand
QUIET = dict(enable_event_bus=False, enable_events=False, enable_crd=False,
             enable_sampler=False, enable_migration=False,
             enable_repartition=False, reconcile_period_s=3600.0,
             slice_membership_ttl_s=0.0)


def wait_until(fn, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


class Host:
    """One simulated host: a port agent, its kubelet, its stub cards."""

    def __init__(self, root, url, worker_id):
        self.node = f"node-{worker_id}"
        base = os.path.join(root, str(worker_id))
        os.makedirs(os.path.join(base, "dev"))
        self.kubelet = FakeKubelet(os.path.join(base, "dp"),
                                   os.path.join(base, "pr", "k.sock"))
        self.kubelet.start()
        self.alloc_dir = os.path.join(base, "alloc")
        self.dp_dir = os.path.join(base, "dp")
        operator = StubOperator(os.path.join(base, "dev"), num_chips=4,
                                worker_id=worker_id,
                                worker_hostnames=HOSTNAMES)
        self.manager = NodeManager(ManagerOptions(
            node_name=self.node, db_path=os.path.join(base, "meta.db"),
            operator=operator, dev_root=os.path.join(base, "dev"),
            device_plugin_dir=self.dp_dir,
            pod_resources_socket=os.path.join(base, "pr", "k.sock"),
            alloc_spec_dir=self.alloc_dir, kube_client=KubeClient(url),
            **QUIET))

    def start(self):
        self.manager.run(block=False)
        assert self.kubelet.wait_registrations(2), "agent did not register"

    def bind(self, api, pod, annotations, units=range(50)):
        """The pod admitted to this node, then Allocate, the kubelet's
        assignment and PreStart over gRPC for ``units`` of card 0; the
        bound spec."""
        api.upsert_pod(make_pod("ml", pod, self.node, annotations=dict(
            {AnnotationAssumed: "true", container_annotation("main"): "0"},
            **annotations)))
        assert wait_until(
            lambda: self.manager.sitter.get_pod("ml", pod) is not None)
        ids = [core_device_id(0, u) for u in units]
        client = rpc.DevicePluginClient(rpc.dial(
            os.path.join(self.dp_dir, CORE_ENDPOINT)))
        client.allocate(ids)
        self.kubelet.assign("ml", pod, "main", ResourceGPUCore, ids)
        client.pre_start_container(ids)
        self.hash = Device(ids, ResourceGPUCore).hash
        return self.spec()

    def spec(self):
        with open(os.path.join(self.alloc_dir, f"{self.hash}.json")) as f:
            return json.load(f)

    def stop(self):
        self.manager.stop()
        self.kubelet.stop()


@pytest.fixture(scope="module")
def fleet():
    root = tempfile.mkdtemp(prefix="mh", dir="/tmp")
    api = FakeAPIServer()
    url = api.start()
    hosts = [Host(root, url, i) for i in range(N_HOSTS)]
    try:
        for h in hosts:
            h.start()
        yield api, hosts
    finally:
        for h in hosts:
            h.stop()
        api.stop()
        shutil.rmtree(root, ignore_errors=True)


def world(env):
    return {k: env.get(k) for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                                    "TPU_ACCELERATOR_TYPE", EnvSliceName,
                                    EnvSliceEpoch)}


def test_host_facts_give_distinct_ids_and_identical_hosts(fleet):
    """No slice annotation: each agent stamps its operator's worker id
    among the four hosts, as the agent's slice env would."""
    api, hosts = fleet
    envs = [world(h.bind(api, f"w{i}", {})["env"])
            for i, h in enumerate(hosts)]
    assert [e["TPU_WORKER_ID"] for e in envs] == ["0", "1", "2", "3"]
    for key in ("TPU_WORKER_HOSTNAMES", "TPU_ACCELERATOR_TYPE"):
        assert len({e[key] for e in envs}) == 1, key
    assert envs[0]["TPU_WORKER_HOSTNAMES"] == ",".join(HOSTNAMES)
    # the agent's derivation from the same host facts (its slice env of
    # this topology, the ICI grid aside)
    for i, (h, env) in enumerate(zip(hosts, envs)):
        op = h.manager.operator
        want = agent_env.slice_env_for_pod({}, op.topology, op.worker_id(),
                                           op.worker_hostnames())
        assert {k: want[k] for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                                     "TPU_ACCELERATOR_TYPE")} == {
            k: env[k] for k in ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
                                "TPU_ACCELERATOR_TYPE")}
        assert env[EnvSliceName] is None      # no slice id: no registry


def test_annotated_slice_forms_and_reforms_consistently(fleet):
    """A slice with its own id, each pod annotated with the hosts in its
    own order: one world; then member 2's pod goes and the survivors
    re-form to one world of three at epoch 1."""
    api, hosts = fleet
    rng = random.Random(5)
    envs = []
    for i, h in enumerate(hosts):
        order = list(HOSTNAMES)
        rng.shuffle(order)
        envs.append(world(h.bind(api, f"s{i}", {
            AnnotationSliceID: "job", AnnotationSliceName: SLICE_TYPE,
            AnnotationSliceWorkerID: str(order.index(HOSTNAMES[i])),
            AnnotationSliceWorkerHosts: ",".join(order)},
            units=range(50, 100))["env"]))
    assert sorted(e["TPU_WORKER_ID"] for e in envs) == ["0", "1", "2", "3"]
    assert len({json.dumps({k: v for k, v in e.items()
                            if k != "TPU_WORKER_ID"}) for e in envs}) == 1
    assert envs[0]["TPU_WORKER_HOSTNAMES"] == ",".join(sorted(HOSTNAMES))
    assert (envs[0]["TPU_ACCELERATOR_TYPE"], envs[0][EnvSliceEpoch]) == (
        SLICE_TYPE, "0")
    for h in hosts:
        st = h.manager.slice_registry.status()["job"]
        assert st["validation_problems"] == [] and st["world_size"] == 4
    api.delete_pod("ml", "s2")
    survivors = [h for i, h in enumerate(hosts) if i != 2]
    reports = [[h.manager.reconciler.reconcile_once() for _ in range(2)]
               for h in survivors]
    assert [[r["slice_reforms"] for r in pair] for pair in reports] == [
        [0, 1]] * 3
    after = [world(h.spec()["env"]) for h in survivors]
    assert sorted(e["TPU_WORKER_ID"] for e in after) == ["0", "1", "2"]
    lost = sorted(HOSTNAMES)
    lost.remove(HOSTNAMES[2])
    assert {e["TPU_WORKER_HOSTNAMES"] for e in after} == {",".join(lost)}
    assert {e[EnvSliceEpoch] for e in after} == {"1"}
    # each survivor's id is its host's index in the one order
    for h, e in zip(survivors, after):
        host = HOSTNAMES[hosts.index(h)]
        assert lost[int(e["TPU_WORKER_ID"])] == host
