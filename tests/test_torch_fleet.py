"""The port's fleet simulator at test scale: fleets of the port's agents
(``NodeManager``, the ``gpushare`` plugins) over the port's fake kubelet
(``tests/torch_fake_kubelet.py``) and one fake apiserver, read through
``FleetAggregator``, held against the agent's ``FleetSim`` on the same
admissions.

- a 2-node fleet, 4 pods a node, churned: every bind lands on its node,
  the aggregator rolls up bind latency and amplification from scraped
  histograms, reconcile convergence is measured per node and tracks a new
  divergence, and each admission trace id follows its pod to the node
  that bound it;
- the agent's 2-node fleet on the same admissions: the same stored binds
  a node, each pod on the same card with the same unit count, and a
  rollup of the same shape;
- a fleet that mixes ``stub:8`` and ``stub:4`` nodes (the counterpart of
  the agent's mixed-generation fleet);
- a maintenance and a preemption notice each start a node's drain, which
  reports the notice to the manager's detection-lag tracker;
- one small ``ScaleHarness`` run through every scenario phase, judged by
  ``scale_problems``.

Socket paths live under a ``tempfile`` directory in /tmp: AF_UNIX caps a
path at ~107 characters.
"""

import tempfile
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent_torch.common import ResourceGPUCore  # noqa: E402
from elastic_tpu_agent_torch.sim import (  # noqa: E402
    FleetAggregator, FleetSim, ScaleHarness, scale_problems,
)
from elastic_tpu_agent_torch.sim.fleet import CONTAINER  # noqa: E402

PODS = 4


@pytest.fixture(scope="module")
def fleet():
    with tempfile.TemporaryDirectory(prefix="etpu-tf", dir="/tmp") as tmp:
        sim = FleetSim(tmp, nodes=2, reconcile_period_s=0.5)
        sim.start()
        try:
            agg = FleetAggregator(sim.targets())
            refs = sim.admit_pods(PODS)
            sim.wait_synced(refs)
            driver = sim.churn(refs, workers_per_node=2)
            yield sim, agg, refs, driver
        finally:
            sim.stop()


def _placement(sim, refs, container, resource):
    """pod key -> (node, card indexes, unit count) of its stored record."""
    out = {}
    for ref in refs:
        info = sim.nodes[ref.node_idx].storage.load(ref.namespace, ref.name)
        rec = info.allocations[container][resource]
        out[ref.pod_key] = (sim.nodes[ref.node_idx].name,
                            list(rec.chip_indexes), len(rec.device.ids))
    return out


def _shape(obj):
    """The nested key structure of a report (values dropped)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return None


def test_every_bind_lands_on_its_node(fleet):
    sim, _, refs, driver = fleet
    assert driver["error_count"] == 0, driver["errors"]
    assert driver["bound"] == len(refs) == 2 * PODS
    assert driver["timed_out_workers"] == 0
    assert sim.stored_binds() == {"sim-0": PODS, "sim-1": PODS}
    placement = _placement(sim, refs, CONTAINER, ResourceGPUCore)
    for ref in refs:
        assert placement[ref.pod_key] == (
            sim.nodes[ref.node_idx].name, [ref.chip], 10)
    # round-robin over each node's four cards
    assert sorted(r.chip for r in refs if r.node_idx == 0) == [0, 1, 2, 3]


def test_aggregator_rolls_up_fleet_bind_latency_and_amplification(fleet):
    _, agg, refs, _ = fleet
    rollup = agg.rollup()
    assert rollup["nodes"] == 2
    stats = rollup["fleet"]
    assert stats["binds_total"] == len(refs)
    assert stats["fleet_bind_p50_ms"] is not None
    assert stats["fleet_bind_p99_ms"] >= stats["fleet_bind_p50_ms"]
    amp = stats["request_amplification"]
    assert amp["kubelet_lists_total"] > 0
    assert amp["kubelet_lists_per_bind"] < 5.0
    assert amp["sink_writes_per_bind"]["events"] > 0
    assert amp["sink_writes_per_bind"]["crd"] > 0
    assert set(rollup["per_node"]) == {"sim-0", "sim-1"}
    for row in rollup["per_node"].values():
        assert row["binds"] == PODS
        assert row["bound_allocations"] == PODS


def test_reconcile_convergence_is_measured_per_node(fleet):
    sim, agg, _, driver = fleet
    convergence = agg.convergence_summary(agg.wait_converged(
        driver["churn_end_ts"], timeout_s=30.0))
    assert convergence["unconverged_nodes"] == []
    assert convergence["max_s"] is not None
    for node in sim.nodes:
        status = node.manager.reconciler.status()
        assert status["last_converged_ts"] > driver["churn_end_ts"]
        assert status["last_duration_s"] is not None


def test_admission_trace_id_follows_pod_to_binding_node(fleet):
    sim, agg, refs, _ = fleet
    continuity = agg.check_continuity([
        (sim.nodes[r.node_idx].name, r.trace_id, r.pod_key) for r in refs])
    assert continuity["fraction"] == 1.0, continuity["broken"]
    traces = agg.trace_lookup(refs[0].trace_id)
    binds = [t for t in traces if t["name"] == "PreStartContainer"]
    assert binds and binds[0]["trace_id"] == refs[0].trace_id
    assert binds[0]["attrs"].get("local_trace_id")
    assert binds[0]["attrs"]["node"] == sim.nodes[refs[0].node_idx].name
    # a trace id of a pod that never bound is broken, not continuous
    broken = agg.check_continuity([("sim-0", "0" * 16, "fleet/ghost")])
    assert broken["fraction"] == 0.0


def test_reconcile_convergence_tracks_new_divergence(fleet):
    """A node that diverges after the churn stops advancing its converged
    timestamp until the reconciler repairs the divergence."""
    sim, agg, refs, _ = fleet
    node = sim.nodes[0]
    ref = next(r for r in refs if r.node_idx == 0)
    rec = node.storage.load(ref.namespace, ref.name)
    link_id = next(iter(
        rec.allocations[CONTAINER].values())).created_node_ids[0]
    node.manager.operator.delete(link_id)
    deadline = time.monotonic() + 30.0
    while not node.manager.operator.check(link_id):
        assert time.monotonic() < deadline, "the link was never restored"
        time.sleep(0.05)
    converged = agg.wait_converged(time.time(), timeout_s=30.0)
    assert converged[node.name] is not None


def test_fleet_binds_as_the_agents_fleet(fleet):
    """The agent's FleetSim on the same admissions (2 nodes of 4 cards, 4
    pods a node, churned): the same stored binds a node, each pod on the
    same node and card with the same unit count, and a rollup and a
    churn report of the same shape."""
    from elastic_tpu_agent.common import ResourceTPUCore
    from elastic_tpu_agent.sim import FleetAggregator as AgentAggregator
    from elastic_tpu_agent.sim import FleetSim as AgentFleetSim

    sim, agg, refs, driver = fleet
    with tempfile.TemporaryDirectory(prefix="etpu-tj", dir="/tmp") as tmp:
        agent = AgentFleetSim(tmp, nodes=2, reconcile_period_s=0.5)
        agent.start()
        try:
            agent_refs = agent.admit_pods(PODS)
            agent.wait_synced(agent_refs)
            agent_driver = agent.churn(agent_refs, workers_per_node=2)
            assert agent_driver["bound"] == driver["bound"]
            assert agent.stored_binds() == sim.stored_binds()
            assert [(r.pod_key, r.node_idx, r.chip) for r in agent_refs] == [
                (r.pod_key, r.node_idx, r.chip) for r in refs]
            assert _placement(agent, agent_refs, "jax", ResourceTPUCore) == (
                _placement(sim, refs, CONTAINER, ResourceGPUCore))
            agent_rollup = AgentAggregator(agent.targets()).rollup()
            assert _shape(agent_rollup) == _shape(agg.rollup())
            assert set(agent_driver) == set(driver)
        finally:
            agent.stop()


def test_fleet_mixes_card_counts():
    """One operator kind a node, cycling: a stub node of 8 cards and one
    of 4, each advertising its own cards, with pods spread over each
    node's own count and a bind landing on both."""
    with tempfile.TemporaryDirectory(prefix="etpu-tm", dir="/tmp") as tmp:
        kinds = ["stub:8", "stub:4"]
        sim = FleetSim(tmp, nodes=3, operator_kinds=kinds,
                       reconcile_period_s=30.0)
        try:
            sim.start()
            assert [n.operator_kind for n in sim.nodes] == [
                "stub:8", "stub:4", "stub:8"]
            assert [len(n.manager.operator.devices()) for n in sim.nodes] == [
                8, 4, 8]
            for node in sim.nodes:
                cards = len(node.manager.operator.devices())
                core = node.manager.plugin.core
                assert len(core.device_list()) == 100 * cards
            refs = sim.admit_pods(pods_per_node=6)
            sim.wait_synced(refs)
            for ref in refs:
                sim.bind_pod(ref)
            assert sim.stored_binds() == {n.name: 6 for n in sim.nodes}
            assert sorted(r.chip for r in refs if r.node_idx == 1) == [
                0, 0, 1, 1, 2, 3]
            assert sorted(r.chip for r in refs if r.node_idx == 0) == [
                0, 1, 2, 3, 4, 5]
        finally:
            sim.stop()


@pytest.mark.parametrize("notice", ["maintenance", "preemption"])
def test_a_node_notice_drains_through_the_lag_tracker(notice):
    """A maintenance or preemption notice on a node's operator starts its
    drain: the drain reports the notice's detection to the manager's lag
    tracker on the way (the port's tracker once lacked ``detected``, and
    every notice crashed the drain loop until its circuit broke)."""
    with tempfile.TemporaryDirectory(prefix="etpu-tn", dir="/tmp") as tmp:
        sim = FleetSim(tmp, nodes=1, reconcile_period_s=30.0,
                       drain_period_s=0.05)
        try:
            sim.start()
            if notice == "maintenance":
                sim.trigger_maintenance(0)
            else:
                sim.trigger_preemption(0)
            state = sim.wait_drain_state(
                0, ("cordoned", "draining", "drained"), timeout_s=30.0)
            status = sim.drain_status(0)
            assert status["trigger"].startswith(notice), status
            assert not status.get("last_error"), status
            if notice == "maintenance":
                sim.clear_maintenance(0)
                assert sim.wait_drain_state(0, "active",
                                            timeout_s=30.0) == "active"
            assert state in ("cordoned", "draining", "drained")
        finally:
            sim.stop()


def test_scale_harness_small_run_passes_the_checker():
    """Two complete agents through every scenario phase (admission waves,
    churn, a drain wave, a slice reform, repartition ticks, a cardinality
    storm), batched, with the structural checker clean. 32 pods a node
    and the harness's own storm of 10,500 series: at 8 or 16 pods both
    packages read ~5.9-6.4 apiserver requests a bind, at the checker's
    bound of 6.0 (the boot's fixed requests and the migration
    coordinator's record LISTs over few binds), and over a storm of
    1,200 series the agents' start-up memory reads near the checker's
    ceiling a series (69 KB on the H100)."""
    with tempfile.TemporaryDirectory(prefix="etpu-ts", dir="/tmp") as tmp:
        harness = ScaleHarness(
            tmp, nodes=2, pods_per_node=32, admission_waves=2,
            drain_nodes=1, slice_world=2,
            storage_batch_window_s=0.005, sink_flush_window_s=0.02,
            reconcile_period_s=1.0, convergence_timeout_s=60.0,
            phase_timeout_s=60.0)
        report = harness.run()
    assert scale_problems(report) == []
    assert report["pods"] == report["stored_binds"]
    waves = report["phases"]["admission_waves"]
    assert waves["bound"] == waves["admitted"] == 64
    assert report["phases"]["slice_reform"]["world"] == 2
    assert report["phases"]["drain_wave"]["nodes"] == 1
    assert report["phases"]["repartition_ticks"]["ticks"] == 2
