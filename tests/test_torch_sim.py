"""The pure parts of the port's fleet simulator (``elastic_tpu_agent_torch/
sim/``) against the agent's ``elastic_tpu_agent/sim/`` on the same inputs.

- traces: the same seeds and knobs give byte-equal lines and digests, and
  a ``TraceCursor`` stepped on each package's ``ManualClock`` hands out
  the same events;
- ``histogram_quantile`` over the agent's tests' bucket sets;
- ``scale_problems`` on the agent's tests' healthy scale report and on
  each of its violation classes (``tests/test_scale.py``);
- ``timeline.merge_node_events`` on the same per-node journals;
- the detection-lag tracker's ``detected`` (the drain's maintenance and
  preemption triggers call it) records as the agent's does.

The chaos programs, schedules and the compound checker are in
``test_torch_chaos.py``; fleets are in ``test_torch_fleet.py``.
"""

import copy
import math

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import common as agent_common  # noqa: E402
from elastic_tpu_agent import latency as agent_latency  # noqa: E402
from elastic_tpu_agent import timeline as agent_timeline  # noqa: E402
from elastic_tpu_agent.sim import aggregator as agent_aggregator  # noqa: E402
from elastic_tpu_agent.sim import scale as agent_scale  # noqa: E402
from elastic_tpu_agent.sim import traffic as agent_traffic  # noqa: E402
from elastic_tpu_agent_torch import common, latency, timeline  # noqa: E402
from elastic_tpu_agent_torch.sim import aggregator, scale, traffic  # noqa: E402

TRACE_CASES = [
    dict(seed=7, duration_s=1.5, base_rps=20.0),
    dict(seed=8, duration_s=1.5, base_rps=20.0),
    dict(seed=11, duration_s=2.0, base_rps=30.0, train_pods=2),
    dict(seed=3, duration_s=2.0, base_rps=30.0, hostile_fraction=1.0),
    dict(seed=1001, duration_s=2.0, base_rps=10.0, train_pods=1),
    dict(seed=2, duration_s=3.0, base_rps=16.0, flash_crowds=2,
         hostile_fraction=0.9, slo_mix={"ttft": 1.0, "batch": 3.0}),
]


@pytest.mark.parametrize("knobs", TRACE_CASES,
                         ids=[str(c["seed"]) for c in TRACE_CASES])
def test_traces_are_byte_equal_to_the_agents(knobs):
    got = traffic.TraceGenerator(**knobs).generate()
    want = agent_traffic.TraceGenerator(**knobs).generate()
    assert got.lines() == want.lines()
    assert got.digest() == want.digest()
    assert got.meta == want.meta
    assert got.requests() == want.requests()
    assert got.pod_events() == want.pod_events()


def test_trace_cursor_on_a_manual_clock_gives_the_agents_events():
    def paced(mod, clock_cls):
        trace = mod.TraceGenerator(seed=5, duration_s=2.0,
                                   base_rps=15.0).generate()
        clock = clock_cls()
        cur = mod.TraceCursor(trace)
        batches = []
        while not cur.exhausted:
            clock.advance(0.25)
            batches.append((cur.remaining, list(cur.due(clock.monotonic()))))
        return batches

    got = paced(traffic, common.ManualClock)
    assert got == paced(agent_traffic, agent_common.ManualClock)
    assert sum(len(b) for _, b in got) > 10


def test_trace_knob_errors_match_the_agents():
    for bad in (dict(duration_s=0.0), dict(hostile_fraction=1.5),
                dict(slo_mix={"interactive": 1.0})):
        with pytest.raises(ValueError) as got:
            traffic.TraceGenerator(seed=1, **bad)
        with pytest.raises(ValueError) as want:
            agent_traffic.TraceGenerator(seed=1, **bad)
        assert str(got.value) == str(want.value)


# the agent's tests' bucket sets (tests/test_fleet.py), and a merged pair
BUCKETS = {
    "interpolate": {0.1: 4.0, 0.5: 10.0, math.inf: 10.0},
    "clamp": {0.1: 0.0, 0.5: 0.0, math.inf: 5.0},
    "empty": {},
    "zero": {0.1: 0.0, math.inf: 0.0},
    "exact": {0.005: 3.0, 0.01: 3.0, 0.025: 9.0, 0.05: 12.0, math.inf: 12.0},
}


@pytest.mark.parametrize("q", [0.0, 0.4, 0.5, 0.7, 0.99, 1.0])
@pytest.mark.parametrize("name", sorted(BUCKETS))
def test_histogram_quantile_matches_the_agents(name, q):
    buckets = BUCKETS[name]
    assert aggregator.histogram_quantile(buckets, q) == (
        agent_aggregator.histogram_quantile(buckets, q))


def test_histogram_quantile_values():
    hq = aggregator.histogram_quantile
    assert hq(BUCKETS["interpolate"], 0.4) == pytest.approx(0.1)
    assert hq(BUCKETS["interpolate"], 0.7) == pytest.approx(0.3)
    assert hq(BUCKETS["clamp"], 0.99) == pytest.approx(0.5)
    assert hq(BUCKETS["empty"], 0.5) is None
    assert hq(BUCKETS["zero"], 0.5) is None


def test_node_scrape_reads_values_and_buckets_as_the_agents():
    samples = {
        "x_bucket": [({"le": "0.1"}, 2.0), ({"le": "+Inf"}, 5.0)],
        "y": [({"sink": "events"}, 3.0), ({"sink": "crd"}, 4.0)],
    }
    got = aggregator.NodeScrape(samples)
    want = agent_aggregator.NodeScrape(samples)
    assert got.buckets("x") == want.buckets("x") == {0.1: 2.0, math.inf: 5.0}
    for args in (("y",), ("y", {"sink": "crd"}), ("z",)):
        assert got.value(*args) == want.value(*args)


def _ok_report():
    """The agent's tests' healthy scale report (tests/test_scale.py)."""
    return {
        "pods": 10,
        "stored_binds": 10,
        "fleet_bind_p99_ms": 5.0,
        "phases": {
            "admission_waves": {"admitted": 10, "bound": 10, "errors": 0},
            "steady_churn": {"deleted": 2, "replaced": 2, "rebound": 2,
                             "errors": 0},
            "drain_wave": {"nodes": 1},
            "slice_reform": {"world": 2},
            "repartition_ticks": {"ticks": 2},
            "cardinality_storm": {"series_inserted": 100, "problems": []},
        },
        "reconcile_convergence_s": {"unconverged_nodes": []},
        "amplification": {
            "kubelet_lists_per_bind": 0.9,
            "apiserver_requests_per_bind": 4.0,
            "sink_writes_per_bind": {"events": 1.1, "crd": 1.2},
        },
        "memory": {
            "rss_delta_per_series_bytes": 5000.0,
            "trace_ring_bytes": 1_000_000,
        },
        "goodput": {
            "goodput_percent": 97.5,
            "downtime_by_cause": {"maintenance_drain": 12.0},
            "conservation_problems": [],
            "unreachable_nodes": [],
        },
    }


def _set(report, path, value):
    *head, last = path
    for k in head:
        report = report[k]
    report[last] = value


# each violation class of the agent's tests' checker test, one at a time,
# and all of them together
VIOLATIONS = {
    "stored": [(("stored_binds",), 9)],
    "waves": [(("phases", "admission_waves", "bound"), 9)],
    "wave_errors": [(("phases", "admission_waves", "errors"), 2)],
    "churn": [(("phases", "steady_churn", "rebound"), 1)],
    "drain_failed": [(("phases", "drain_wave", "failed"), True)],
    "storm": [(("phases", "cardinality_storm", "problems"), ["n0: 9 > 8"])],
    "unconverged": [(("reconcile_convergence_s", "unconverged_nodes"),
                     ["sim-1"])],
    "lists": [(("amplification", "kubelet_lists_per_bind"), 5.0)],
    "api": [(("amplification", "apiserver_requests_per_bind"), None)],
    "sinks": [(("amplification", "sink_writes_per_bind", "crd"), 9.0)],
    "memory": [(("memory", "rss_delta_per_series_bytes"), 10 * 1024 * 1024)],
    "ring": [(("memory", "trace_ring_bytes"), 1 << 30)],
    "p99": [(("fleet_bind_p99_ms",), None)],
    "goodput": [(("goodput",), {"goodput_percent": None,
                                "conservation_problems": [
                                    "p overlap at t=3"]})],
}
VIOLATIONS["all"] = [v for k in ("stored", "waves", "unconverged", "lists",
                                  "memory", "goodput")
                     for v in VIOLATIONS[k]]


@pytest.mark.parametrize("name", ["healthy"] + sorted(VIOLATIONS))
def test_scale_problems_equal_the_agents(name):
    report = _ok_report()
    for path, value in VIOLATIONS.get(name, []):
        _set(report, path, value)
    got = scale.scale_problems(copy.deepcopy(report))
    assert got == agent_scale.scale_problems(copy.deepcopy(report))
    assert (got == []) == (name == "healthy")
    if name == "all":
        joined = "\n".join(got)
        for needle in ("stored binds", "admission waves", "unconverged",
                       "kubelet_lists_per_bind", "ceiling",
                       "goodput: fleet rollup missing",
                       "goodput conservation: p overlap at t=3"):
            assert needle in joined


def test_merge_node_events_equals_the_agents():
    per_node = {
        "sim-1": [{"seq": 1, "ts": 1.0, "kind": "a"},
                  {"seq": 2, "ts": 5.0, "kind": "b"},
                  {"seq": 3, "ts": 4.0, "kind": "c"}],
        "sim-0": [{"seq": 1, "ts": 1.0, "kind": "d"},
                  {"seq": 2, "ts": 3.0, "kind": "e"}],
        "sim-2": [],
        "sim-3": [{"seq": 7, "kind": "no-ts"}],
    }
    got = timeline.merge_node_events(per_node)
    assert got == agent_timeline.merge_node_events(per_node)
    # one node's seq order is never broken, ties break by node name
    assert [e["kind"] for e in got] == ["no-ts", "d", "a", "e", "b", "c"]
    assert timeline.merge_node_events({}) == []


def test_detection_lag_detected_records_as_the_agents():
    """The drain calls ``detected`` when a maintenance or preemption
    notice appears; the mark stays for the repair that follows."""
    def run(mod, clock_cls):
        clock = clock_cls()
        tracker = mod.DetectionLagTracker(clock=clock)
        tracker.mark("maintenance", "node-a")
        clock.advance(0.5)
        first = tracker.detected("drain", "maintenance", key="node-a",
                                 origin_ts=clock.time() - 0.25)
        again = tracker.detected("drain", "maintenance", key="node-a",
                                 origin_ts=clock.time() - 0.25)
        nothing = tracker.detected("drain", "preempted", key="node-a")
        clock.advance(0.5)
        repaired = tracker.repaired("drain", "maintenance", key="node-a")
        return first, again, nothing, repaired, tracker.status()

    got = run(latency, common.ManualClock)
    assert got == run(agent_latency, agent_common.ManualClock)
    assert got[0] == pytest.approx(0.25) and got[2] is None
