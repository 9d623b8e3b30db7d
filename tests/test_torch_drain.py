"""The port's drain orchestrator (``drain.py``) against the agent's.

Each side runs on ``tests/torch_agent_rig.py``: its own plugins, store,
reconciler and fake kubelet over the port's 4-card stub, a fake apiserver
for the node annotation, and the side's ``DrainOrchestrator``,
``MigrationCoordinator`` and sampler on its ``ManualClock``
(``Handshake``). Two pods are bound (a: 50 core units and a quarter of the
memory of card 2, a slice member; b: 100 core units of card 1), then one
script of trigger changes, clock advances and ``tick()`` calls runs on
both: maintenance (and its cancel), the preemption notice (its deadline
clamped to the notice, then the deadline reclaim with replays
suppressed), the node annotation (a slice member annotated draining, and
the cancel's cleanup), a requested drain whose residents exit, a
preemption arriving mid-maintenance, and an agent restarted mid-drain
that resumes from the journal. After every step the states, the drain's
status, the restamped specs, the records, the Events, the cordon, the
drain's metric samples and its timeline rows must be equal once the
names are mapped.

Across agents: the draining node's slice member is counted lost by a peer's
SliceRegistry (over the same apiserver) while its host still holds it, and
the peer's SliceReformer re-forms its own member around the loss, then
back when the drain is cancelled, on both sides alike.
"""

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent_torch.common import (  # noqa: E402
    AnnotationDrain,
    AnnotationDraining,
    EnvDrain,
    EnvDrainDeadline,
)

from elastic_tpu_agent import slices as agent_slices  # noqa: E402
from elastic_tpu_agent.kube.client import KubeClient as AgentKube  # noqa: E402
from elastic_tpu_agent_torch import slices  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    AnnotationSliceID,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
    EnvSliceEpoch,
    EnvSliceName,
)
from elastic_tpu_agent_torch.kube.client import KubeClient  # noqa: E402
from elastic_tpu_agent_torch.types import PodContainer  # noqa: E402

from torch_agent_rig import (  # noqa: E402
    HANDSHAKE_SETS,
    HandshakeSide,
    hash_map,
    to_agent,
)

MAINT = "TERMINATE_ON_HOST_MAINTENANCE"


def spec_env(side):
    """The drain keys of every spec, in the order of HANDSHAKE_SETS."""
    specs = side.node.state()["specs"]
    out = []
    for kind, chip, units in HANDSHAKE_SETS:
        h = side.node.device(kind, side.node.ids(kind, chip, units)).hash
        spec = specs.get(f"{h}.json")
        if spec is not None:
            out.append({k: v for k, v in spec["env"].items()
                        if k.startswith("ELASTIC_TPU_DRAIN")})
    return out


def maintenance(side, step):
    step("quiet", side.hs.drain.tick())
    side.node.gen.operator.set_maintenance_event(MAINT)
    step("announced", side.hs.drain.tick())
    side.node.gen.operator.set_maintenance_event("NONE")
    step("cleared", side.hs.drain.tick())


def preemption(side, step):
    with side.faults.armed("drain.preempt-notice", "notice:1"):
        step("notice", side.hs.drain.tick())
    side.clock.advance(15)
    step("inside the notice", side.hs.drain.tick())
    side.clock.advance(16)
    step("past the notice", side.hs.drain.tick())
    # the kubelet still lists both pods' assignments: no replay
    report = side.node.gen.reconciler.reconcile_once()
    step("reconciled", {k: report[k] for k in (
        "replayed_binds", "restored_links", "restored_specs")})


def annotation(side, step):
    side.api.annotate_node("node-a", AnnotationDrain, "true")
    step("annotated", side.hs.drain.tick())
    step("draining pod", side.api.get_pod("default", "a")["metadata"][
        "annotations"].get(AnnotationDraining))
    side.api.annotate_node("node-a", AnnotationDrain, None)
    step("removed", side.hs.drain.tick())
    step("cleared pod", side.api.get_pod("default", "a")["metadata"][
        "annotations"].get(AnnotationDraining))


def residents_exit(side, step):
    side.hs.drain.request_drain("maintenance-window")
    step("requested", side.hs.drain.tick())
    side.exit_pod("a")
    step("a exited", side.hs.drain.tick())
    side.exit_pod("b")
    step("b exited", side.hs.drain.tick())
    side.hs.drain.cancel_request()
    step("request cancelled", side.hs.drain.tick())


def upgrade(side, step):
    side.node.gen.operator.set_maintenance_event(MAINT)
    step("maintenance", side.hs.drain.tick())
    side.clock.advance(100)
    with side.faults.armed("drain.preempt-notice", "notice:1"):
        step("preempted", side.hs.drain.tick())
    side.node.gen.operator.set_maintenance_event("NONE")
    side.clock.advance(31)
    step("never cancels", side.hs.drain.tick())


def restart(side, step):
    side.hs.drain.request_drain()
    step("requested", side.hs.drain.tick())
    hs = side.boot()                      # the agent restarts
    hs.drain.request_drain()              # the admin's request stands
    hs.drain.resume()
    step("resumed", hs.drain.state)
    side.clock.advance(301)
    step("past the deadline", hs.drain.tick())


SCRIPTS = {f.__name__: f for f in (maintenance, preemption, annotation,
                                   residents_exit, upgrade, restart)}


def run(name, port):
    side = HandshakeSide(port)
    trace = []

    def step(label, value):
        trace.append((label, value, side.hs.snapshot(), spec_env(side)))

    try:
        SCRIPTS[name](side, step)
        return trace
    finally:
        side.close()


@pytest.fixture(scope="module")
def hashes():
    return hash_map(HANDSHAKE_SETS)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_drain_script_matches_the_agents(name, hashes):
    port, agent = run(name, True), run(name, False)
    assert [t[0] for t in port] == [t[0] for t in agent]
    for p, a in zip(port, agent):
        assert to_agent(p[1:], hashes) == to_agent(a[1:], {}), p[0]
    check = CHECKS[name]
    check({label: (value, snap, envs) for label, value, snap, envs in port})


def _maintenance(t):
    assert t["quiet"][0] == "active" and not t["quiet"][1]["cordoned"]
    value, snap, envs = t["announced"]
    assert value == "draining" and snap["cordoned"]
    assert snap["drain"]["trigger"] == f"maintenance:{MAINT}"
    assert snap["drain"]["stamped_pods"] == ["default/a", "default/b"]
    assert all(e[EnvDrain] == f"maintenance:{MAINT}" for e in envs)
    reasons = [r for _, r in snap["events"]]
    assert reasons.count("TPUNodeDraining") == 3     # the node, a and b
    assert "TPUMaintenanceImminent" in reasons
    # the cordon fails no health: no card Unhealthy, no health Event
    assert not any("ChipUnhealthy" in r for r in reasons)
    value, snap, envs = t["cleared"]
    assert value == "active" and not snap["cordoned"]
    assert snap["drain"]["outcome"] == "cancelled"
    assert envs and not any(envs)                     # the stamp removed
    assert "TPUDrainCancelled" in [r for _, r in snap["events"]]
    assert snap["samples"][
        "elastic_tpu_drains_total{outcome=cancelled,trigger=maintenance}"] == 1


def _preemption(t):
    value, snap, envs = t["notice"]
    drain = snap["drain"]
    assert value == "draining" and drain["trigger"] == "preemption:notice"
    assert drain["deadline_in_s"] == 30.0             # min(300, notice)
    assert all(EnvDrainDeadline in e for e in envs)
    assert t["inside the notice"][0] == "draining"
    value, snap, _ = t["past the notice"]
    assert value == "reclaimed"
    assert snap["drain"]["reclaimed_pods"] == ["default/a", "default/b"]
    assert snap["state"]["records"] == {} and snap["state"]["links"] == {}
    assert t["reconciled"][0] == dict(replayed_binds=0, restored_links=0,
                                      restored_specs=0)


def _annotation(t):
    assert t["annotated"][0] == "draining"
    assert t["annotated"][1]["drain"]["trigger"] == "operator:annotation"
    assert t["draining pod"][0] == "true"             # the slice member
    assert t["annotated"][1]["drain"]["annotated_pods"] == ["default/a"]
    assert t["removed"][0] == "active"
    assert t["cleared pod"][0] is None
    assert t["removed"][1]["drain"]["annotated_pods"] == []


def _residents_exit(t):
    assert t["requested"][1]["drain"]["trigger"] == (
        "operator:maintenance-window")
    assert t["a exited"][0] == "draining"
    value, snap, _ = t["b exited"]
    assert value == "drained"
    # exits acked no checkpoint: nothing proves the work was saved
    assert snap["drain"]["outcome"] == "drained_exited"
    assert sorted(k for k in snap["samples"]
                  if k.startswith("elastic_tpu_drain_phase_seconds_count")) \
        == ["elastic_tpu_drain_phase_seconds_count{phase=cordon_to_signaled}",
            "elastic_tpu_drain_phase_seconds_count{phase=signaled_to_drained}"]
    assert t["request cancelled"][0] == "active"


def _upgrade(t):
    before = t["maintenance"][1]["drain"]["deadline_ts"]
    drain = t["preempted"][1]["drain"]
    assert drain["trigger"] == "preemption:notice"
    assert drain["deadline_ts"] == before - 300 + 100 + 30   # clamped
    assert t["never cancels"][0] == "reclaimed"


def _restart(t):
    value, snap, _ = t["resumed"]
    assert value == "draining" and snap["cordoned"]
    kinds = [k for k, _ in snap["timeline"]]
    assert kinds.count("drain_transition") >= 3        # + the resumed row
    assert t["past the deadline"][0] == "reclaimed"


CHECKS = {"maintenance": _maintenance, "preemption": _preemption,
          "annotation": _annotation, "residents_exit": _residents_exit,
          "upgrade": _upgrade, "restart": _restart}


class _PeerSpecs:
    """The peer's member container: one spec, in memory."""

    def __init__(self, env):
        self.spec = {"env": dict(env)}

    def read_alloc_spec(self, h):
        return {"env": dict(self.spec["env"])} if h == "peer" else None

    def restamp_spec_env_locked(self, owner, records, env_updates,
                                remove_keys=()):
        self.spec["env"].update(env_updates)
        return 1


def _member_lost_before_its_host_goes(port):
    """Pod a (host h1 of slice job-1, on this draining node) and a peer's
    member on h0; the peer's registry and reformer over the apiserver."""
    side = HandshakeSide(port)
    try:
        hosts = {AnnotationSliceID: "job-1",
                 AnnotationSliceWorkerHosts: "h0,h1"}
        a = side.api.get_pod("default", "a")
        a["metadata"]["annotations"].update(hosts)
        a["metadata"]["annotations"][AnnotationSliceWorkerID] = "1"
        side.api.upsert_pod(a)
        side.api.upsert_pod({"metadata": {
            "namespace": "default", "name": "peer", "uid": "uid-peer",
            "annotations": dict(hosts, **{AnnotationSliceWorkerID: "0"})}})
        sl = slices if port else agent_slices
        registry = sl.SliceRegistry(
            node_name="node-b", membership_ttl_s=0.0,
            kube_client=(KubeClient if port else AgentKube)(side.url))
        specs = _PeerSpecs({
            "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0,h1",
            "TPU_ACCELERATOR_TYPE": "(unparsed)", EnvSliceName: "job-1",
            EnvSliceEpoch: "0"})
        reformer = sl.SliceReformer(
            registry, type("P", (), {"core": specs})())
        owner = PodContainer("default", "peer", "main")
        records = {"peer": type("R", (), {"device": type(
            "D", (), {"hash": "peer"})()})()}
        out = [reformer.divergence(owner, records)]
        side.api.annotate_node("node-a", AnnotationDrain, "true")
        out.append(side.hs.drain.tick())
        # the host still holds its member: bound, alive at the apiserver
        out.append((sorted(side.node.state()["records"]),
                    side.api.has_pod("default", "a")))
        div = reformer.divergence(owner, records)
        out += [div, reformer.reform(owner, records, div),
                dict(specs.spec["env"])]
        side.api.annotate_node("node-a", AnnotationDrain, None)
        out.append(side.hs.drain.tick())
        div = reformer.divergence(owner, records)
        out += [div, reformer.reform(owner, records, div),
                dict(specs.spec["env"]), registry.status()]
        return out
    finally:
        side.close()


def test_a_draining_member_is_lost_to_its_peer_before_its_host_goes():
    port = _member_lost_before_its_host_goes(True)
    assert port == _member_lost_before_its_host_goes(False)
    assert port[0] is None
    assert port[1] == "draining"
    assert port[2] == (["default/a", "default/b"], True)
    assert port[3]["lost"] == ["h1"] and port[3]["new_hosts"] == ["h0"]
    assert port[4] == 1
    assert (port[5]["TPU_WORKER_HOSTNAMES"], port[5][EnvSliceEpoch]) == (
        "h0", "1")
    assert port[6] == "active"
    assert port[7]["joined"] == ["h1"] and port[8] == 2
    assert port[9]["TPU_WORKER_HOSTNAMES"] == "h0,h1"
    assert port[10]["job-1"]["reforms_total"] == 2
