"""The port's chaos matrix (``elastic_tpu_agent_torch/sim/chaos.py``)
against the agent's on the same inputs.

Fast tier (pure data and tiny rigs, no fleet):
- ``ChaosProgram.generate`` on the same seeds and knobs: equal
  ``lines()``, ``digest()``, ``ops()``, ``overlaps()`` and meta; an
  ``OpCursor`` stepped on each package's ``ManualClock`` fires the same
  ops; ``ChaosMatrix.schedules()`` and ``schedule_digest()`` are equal;
- the compound checker (``scale_problems`` on a chaos report) on the
  agent's tests' balanced report, on each violation class and with the
  goodput and SLO floors, equal to the agent's;
- ``repro_line``: the agent's format with the port's own replay command;
- the throttle drive under a flush fault: the port retries a failed
  controller tick, where the agent's sim lets it end the run;
- the two pinned regressions of the agent's tests, against the port's
  ``KubeClient`` and store: a brownout's 503 is a ``KubeError`` (never a
  NotFound) and replays from its seed, and a failed group commit rolls
  back and lands once on retry.

Slow tier (a real 2-node fleet of the port's agents, marked as the
agent's are; ``chip_smoke.py`` phase 32c runs both on the H100):
- the compound scenario: a maintenance drain during a slice reform
  during a throttle, under live trace traffic, with the full invariant
  set;
- the sabotaged known-bad run, which must trip the checker and carry the
  repro line.
"""

import copy
import tempfile
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import common as agent_common  # noqa: E402
from elastic_tpu_agent.sim import chaos as agent_chaos  # noqa: E402
from elastic_tpu_agent.sim import scale as agent_scale  # noqa: E402
from elastic_tpu_agent.sim import traffic as agent_traffic  # noqa: E402
from elastic_tpu_agent_torch import faults  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    EnvSliceEpoch, ManualClock, ResourceGPUCore,
)
from elastic_tpu_agent_torch.kube.client import (  # noqa: E402
    KubeClient, KubeError,
)
from elastic_tpu_agent_torch.sim import (  # noqa: E402
    ChaosMatrix, ChaosProgram, FleetSim, OpCursor, ScenarioRunner,
    TraceGenerator, chaos, repro_line, scale_problems, traffic,
)
from elastic_tpu_agent_torch.storage import Storage, StorageError  # noqa: E402
from elastic_tpu_agent_torch.types import (  # noqa: E402
    AllocationRecord, Device, PodInfo,
)

from fake_apiserver import FakeAPIServer, make_pod  # noqa: E402

PROGRAM_CASES = [
    dict(seed=42, duration_s=3.0, nodes=2),
    dict(seed=43, duration_s=3.0),
    dict(seed=9, duration_s=2.0, nodes=2, include_throttle=True),
    dict(seed=5, duration_s=4.0, nodes=4, intensity=3.0,
         include_preemption=True),
    dict(seed=6, duration_s=2.5, nodes=3, include_drain=False,
         include_preemption=True),
    dict(seed=7, duration_s=1.0, nodes=1),
]


@pytest.mark.parametrize("knobs", PROGRAM_CASES,
                         ids=[str(c["seed"]) for c in PROGRAM_CASES])
def test_programs_equal_the_agents(knobs):
    got = ChaosProgram.generate(**knobs)
    want = agent_chaos.ChaosProgram.generate(**knobs)
    assert got.lines() == want.lines()
    assert got.digest() == want.digest()
    assert got.ops() == want.ops()
    assert got.overlaps() == want.overlaps() >= 1
    assert got.end_t() == want.end_t()
    assert got.meta == want.meta


def test_op_cursor_on_a_manual_clock_fires_the_agents_ops():
    def fired(mod, cursor_cls, clock_cls):
        prog = mod.ChaosProgram.generate(seed=9, duration_s=2.0, nodes=2,
                                         include_throttle=True)
        clock = clock_cls()
        cur = cursor_cls(prog.ops())
        out = []
        while not cur.exhausted:
            clock.advance(0.1)
            out.append([(o["op"], o["id"], o["t"])
                        for o in cur.due(clock.monotonic())])
        return out

    got = fired(chaos, OpCursor, ManualClock)
    assert got == fired(agent_chaos, agent_chaos.OpCursor,
                        agent_common.ManualClock)
    assert sum(len(b) for b in got) > 5


@pytest.mark.parametrize("seeds", [(1, 1), (3, 4), (3, 5)])
def test_matrix_schedules_equal_the_agents(seeds):
    got = ChaosMatrix(trace_seed=seeds[0], chaos_seed=seeds[1])
    want = agent_chaos.ChaosMatrix(trace_seed=seeds[0], chaos_seed=seeds[1])
    assert got.scenarios == want.scenarios
    assert got.schedules() == want.schedules()
    assert got.schedule_digest() == want.schedule_digest()


def test_repro_line_keeps_the_format_and_names_the_ports_command():
    """The agent's line runs its bench (and the agent's sim); the port's
    keeps the format and runs the port's."""
    args = (1001, 2001, "drain-under-hostile-prefix")
    got, want = repro_line(*args), agent_chaos.repro_line(*args)
    assert got == (
        "python -m elastic_tpu_agent_torch.sim --trace-seed 1001 "
        "--chaos-seed 2001 --scenario drain-under-hostile-prefix")
    agent_cmd = "python bench.py --chaos-matrix-smoke"
    assert want.startswith(agent_cmd)
    assert got.replace(chaos.REPRO_COMMAND, agent_cmd, 1) == want


def test_replay_command_rejects_an_unknown_scenario():
    from elastic_tpu_agent_torch.sim.__main__ import main

    assert main(["--scenario", "no-such-scenario"]) == 2


class _FailingController:
    """A repartition controller whose journal write fails, as a flush
    fault of the program fails it."""

    def __init__(self, error):
        self.error = error
        self.ticks = 0

    def tick(self, now=None):  # noqa: ARG002
        self.ticks += 1
        raise self.error


def _throttle_fleet(tmp, error):
    node = type("Node", (), {})()
    node.opts = type("Opts", (), {"alloc_spec_dir": tmp})()
    node.manager = type("Manager", (), {})()
    node.manager.sampler = type("Sampler", (), {
        "sample_once": lambda self, now=None: None})()
    node.manager.repartition = _FailingController(error)
    return type("Fleet", (), {"nodes": [node]})()


def test_a_flush_fault_in_the_throttle_drive_is_retried_not_fatal(tmp_path):
    """The throttle drive ticks the node's controller by hand; under the
    program's flush fault its journal write can fail. The port counts the
    failure and drives again on the next tick (as the supervisor restarts
    a failed tick in the agent); the agent's sim lets it end the run,
    which on the H100 ended the compound scenario mid-program."""
    def drive(mod, err_cls):
        fleet = _throttle_fleet(str(tmp_path), err_cls("group commit failed"))
        program = mod.ChaosProgram(1, [], {})
        tgen = agent_traffic if mod is agent_chaos else traffic
        trace = tgen.TraceGenerator(seed=1, duration_s=1.0).generate()
        runner = mod.ScenarioRunner(fleet, trace, program)
        runner.throttle_nodes[0] = {"calm_hash": "c", "hog_hash": "h"}
        runner._throttle_drive(0, 90.0)
        runner._throttle_drive(0, 90.0)
        return runner, fleet.nodes[0].manager.repartition

    from elastic_tpu_agent.storage import StorageError as AgentStorageError

    runner, controller = drive(chaos, StorageError)
    assert controller.ticks == 2
    assert runner.throttle_errors == ["node-0: StorageError"] * 2
    with pytest.raises(AgentStorageError):
        drive(agent_chaos, AgentStorageError)


def _clean_report():
    """The agent's tests' balanced compound report (tests/test_chaos.py)."""
    return {
        "scenario": "unit",
        "repro": repro_line(1, 1, "unit"),
        "goodput": {
            "goodput_percent": 97.5,
            "conservation_problems": [],
            "unreachable_nodes": [],
        },
        "slo": {"ttft": {"attainment": 1.0}, "tpot": {"attainment": 0.98}},
        "compound": {
            "streams": {
                "admitted": 10, "finished": 10, "live_leftover": 0,
                "pending_handoff_leftover": 0, "client_visible_drops": 0,
                "finish_reasons": {"released": 10},
            },
            "handoffs": {"published": 2, "adopted": 2, "expired": 0},
            "worst_residual_s": 0.001,
            "tokens": {"emitted": 500, "accounted": 500},
            "binds": {
                "serve_pods": 4, "double_lands": 0,
                "records_missing": 0, "bind_errors_during_faults": 1,
            },
            "open_intents": 0,
            "throttled": {},
        },
        "recovery": {
            "binds_never_landed": [], "reclaimed_bind_replays": [],
        },
    }


def _edit(report, path, value):
    *head, last = path
    for k in head:
        report = report[k]
    report[last] = value


# each violation class of the agent's tests' checker tests, one at a time
COMPOUND_VIOLATIONS = {
    "drops": (("compound", "streams", "client_visible_drops"), 3),
    "finished": (("compound", "streams", "finished"), 7),
    "live": (("compound", "streams", "live_leftover"), 1),
    "pending": (("compound", "streams", "pending_handoff_leftover"), 2),
    "expired": (("compound", "handoffs", "expired"), 1),
    "unadopted": (("compound", "handoffs", "adopted"), 1),
    "residual": (("compound", "worst_residual_s"), -0.2),
    "tokens": (("compound", "tokens", "accounted"), 400),
    "double": (("compound", "binds", "double_lands"), 1),
    "missing": (("compound", "binds", "records_missing"), 2),
    "intents": (("compound", "open_intents"), 2),
    "never_landed": (("recovery", "binds_never_landed"), ["train/t-1"]),
    "replays": (("recovery", "reclaimed_bind_replays"), ["train/t-0"]),
    "reclaim": (("recovery", "reclaim_error"), "t-0 never reclaimed"),
    "recovery": (("recovery", "problems"), ["hog-0 never unthrottled"]),
    "conservation": (("goodput", "conservation_problems"),
                     ["pod x: gap 0.2s"]),
    "goodput_missing": (("goodput", "goodput_percent"), None),
}

FLOORS = {"min_goodput_percent": 90.0, "min_slo_attainment": 0.9}


@pytest.mark.parametrize("floors", [None, FLOORS], ids=["plain", "floors"])
@pytest.mark.parametrize("name", ["clean", "low_scores"]
                         + sorted(COMPOUND_VIOLATIONS))
def test_compound_checker_equals_the_agents(name, floors):
    report = _clean_report()
    if name == "low_scores":
        report["goodput"]["goodput_percent"] = 40.0
        report["slo"]["tpot"]["attainment"] = 0.5
    elif name != "clean":
        _edit(report, *COMPOUND_VIOLATIONS[name])
    got = scale_problems(copy.deepcopy(report), floors)
    assert got == agent_scale.scale_problems(copy.deepcopy(report), floors)
    clean = name == "clean" or (name == "low_scores" and floors is None)
    assert (got == []) == clean, got


# -- pinned regression: a brownout 503 is an outage, never a deletion --------


def test_brownout_503_surfaces_as_kube_error_never_notfound_seed_20260807():
    """The agent's pinned regression, on the port's KubeClient: during a
    brownout (error_rate 1.0, seed 20260807) every get raises KubeError,
    even for a pod that does not exist; after it, gets answer again."""
    api = FakeAPIServer()
    base = api.start()
    try:
        api.upsert_pod(make_pod("default", "alive", "node-a"))
        client = KubeClient(base)
        assert client.get_pod("default", "alive") is not None
        api.set_brownout(error_rate=1.0, seed=20260807)
        with pytest.raises(KubeError):
            client.get_pod("default", "alive")
        with pytest.raises(KubeError):
            client.get_pod("default", "ghost")
        api.clear_brownout()
        assert client.get_pod("default", "alive") is not None
        assert client.get_pod("default", "ghost") is None
        counts = api.request_counts
        assert counts.get("pod_get_failed", 0) >= 2
        assert counts.get("pod_get", 0) >= 2
    finally:
        api.stop()


def test_brownout_failure_sequence_replays_from_its_seed():
    def run_once():
        api = FakeAPIServer()
        base = api.start()
        try:
            api.upsert_pod(make_pod("default", "p", "node-a"))
            client = KubeClient(base)
            api.set_brownout(error_rate=0.5, seed=99)
            outcomes = []
            for _ in range(12):
                try:
                    client.get_pod("default", "p")
                    outcomes.append("ok")
                except KubeError:
                    outcomes.append("503")
            return outcomes
        finally:
            api.stop()

    a, b = run_once(), run_once()
    assert a == b
    assert "503" in a and "ok" in a


# -- pinned regression: a flaky group commit rolls back, lands once -----------


def _pod_info(name):
    return PodInfo(
        namespace="train",
        name=name,
        allocations={
            "main": {
                ResourceGPUCore: AllocationRecord(
                    device=Device(("d1",), ResourceGPUCore),
                    chip_indexes=[0],
                    created_node_ids=[],
                )
            }
        },
    )


def test_flush_fault_rolls_back_then_lands_once_on_retry_seed_20260807():
    """The agent's pinned regression, on the port's store: a failed group
    commit (storage.batch_flush raise-once, a 0.02 s window) is a
    StorageError with nothing landed, and the retry lands exactly once."""
    with tempfile.TemporaryDirectory(prefix="etpu-flush", dir="/tmp") as tmp:
        path = f"{tmp}/meta.db"
        store = Storage(path, batch_window_s=0.02)
        try:
            faults.get_registry().arm("storage.batch_flush", "raise-once")
            with pytest.raises(StorageError):
                store.save(_pod_info("flaky"))
            reader = Storage(path)
            try:
                assert reader.load("train", "flaky") is None
            finally:
                reader.close()
            store.save(_pod_info("flaky"))
            reader = Storage(path)
            try:
                assert reader.load("train", "flaky") is not None
                assert reader.count() == 1
            finally:
                reader.close()
        finally:
            faults.get_registry().disarm()
            store.close()


# -- the compound scenario itself (slow tier: a real 2-node fleet) -----------

chaos_tier = pytest.mark.slow


def _chaos_fleet(tmp):
    return FleetSim(
        tmp,
        nodes=2,
        reconcile_period_s=0.5,
        slice_membership_ttl_s=0.25,
        drain_deadline_s=30.0,
        drain_period_s=0.25,
        migration_period_s=0.1,
        goodput_period_s=3600.0,
        enable_sampler=True,
        sampler_period_s=3600.0,
        repartition_period_s=3600.0,
        storage_batch_window_s=0.004,
        sink_flush_window_s=0.02,
    )


# the agent's tests' handcrafted program: a drain on node 1 (which forces
# the slice's reform on node 0) overlapping a throttle on node 0, under a
# brownout, a flaky group commit and a kubelet flap
COMPOUND_ACTIONS = [
    {"kind": "failpoint", "t": 0.2, "duration_s": 1.5,
     "point": "storage.batch_flush", "spec": "prob:0.1:11"},
    {"kind": "apiserver_brownout", "t": 0.3, "duration_s": 1.2,
     "error_rate": 0.2, "latency_s": 0.001, "seed": 7},
    {"kind": "throttle", "t": 0.4, "duration_s": 2.2, "node": 0},
    {"kind": "maintenance_drain", "t": 0.5, "duration_s": 2.5, "node": 1},
    {"kind": "kubelet_flap", "t": 1.0, "node": 0},
]


@chaos_tier
def test_compound_drain_during_reform_during_throttle():
    with tempfile.TemporaryDirectory(prefix="etpu-cx", dir="/tmp") as tmp:
        sim = _chaos_fleet(tmp)
        sim.start()
        try:
            slice_refs = sim.admit_slice("cx", [0, 1])
            sim.wait_synced(slice_refs)
            for ref in slice_refs:
                sim.bind_pod(ref)
            trace = TraceGenerator(
                seed=1001, duration_s=2.0, base_rps=10.0, train_pods=1,
            ).generate()
            program = ChaosProgram(2001, copy.deepcopy(COMPOUND_ACTIONS), {
                "chaos_seed": 2001, "duration_s": 3.0, "nodes": 2})
            assert program.overlaps() >= 3
            report = ScenarioRunner(
                sim, trace, program, name="drain-reform-throttle").run()
            problems = scale_problems(report, {
                "min_goodput_percent": 10.0, "min_slo_attainment": 0.5})
            assert problems == [], problems
            comp = report["compound"]
            assert comp["streams"]["admitted"] > 0
            assert comp["streams"]["client_visible_drops"] == 0
            assert comp["handoffs"]["published"] == \
                comp["handoffs"]["adopted"]
            assert comp["throttled"].get("node-0") is True
            assert report["repro"] == repro_line(
                1001, 2001, "drain-reform-throttle")
            deadline = time.monotonic() + 15.0
            epoch = -1
            while time.monotonic() < deadline:
                epoch = int(sim.slice_env_of(slice_refs[0]).get(
                    EnvSliceEpoch, -1))
                if epoch >= 1:
                    break
                time.sleep(0.1)
            assert epoch >= 1, f"slice never reformed: epoch={epoch}"
        finally:
            faults.get_registry().disarm()
            sim.stop()


@chaos_tier
def test_sabotaged_run_trips_the_checker_with_a_repro_line():
    matrix = ChaosMatrix(trace_seed=1, chaos_seed=1)
    matrix.scenarios = [{
        "name": "self-test",
        "index": 0,
        "trace": {
            "duration_s": 1.0, "base_rps": 10.0,
            "flash_crowds": 0, "train_pods": 0,
        },
        "program": {"duration_s": 1.0, "include_drain": False},
    }]
    with tempfile.TemporaryDirectory(prefix="etpu-st", dir="/tmp") as tmp:
        verdict = matrix.self_test(tmp)
    assert verdict["tripped"]
    assert any("drops" in p for p in verdict["problems"])
    assert verdict["repro"] == repro_line(1, 1, "self-test")
