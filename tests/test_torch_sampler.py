"""The port's utilization sampler (``sampler.py``) against the agent's.

Each side runs on ``tests/torch_agent_rig.py`` (``HandshakeSide``): pods a
(50 core units and a quarter of the memory of card 2) and b (100 core
units of card 1), and here pod c (25 core units of card 2), over the
port's 4-card stub, with the side's ``UtilizationSampler`` and an
AgentMetrics. One sequence of stub readings and usage files goes through
``sample_once(now=...)`` on both: proportional attribution on a shared
card, a fresh self-report (which wins, the rest split among the others), a
stale one and one stamped in the future (both ignored), a flight summary,
a sustained overcommit (one episode a pod, one ``tpu_overcommit`` log
record each with the bind's trace id), and a card whose telemetry fails
three times (flagged, folded by the plugin's health poll into Unhealthy,
released when the reading goes). The joins, windows, ``utilization_view``,
``allocations_snapshot``, the metric samples, the log records and the
plugins' health must be equal once names, hashes and trace ids are
mapped; each side's diagnostics bundle passes both sides'
``validate_bundle``.
"""

import json
import logging
import re

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import sampler as agent_sampler  # noqa: E402
from elastic_tpu_agent_torch import sampler  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry  # noqa: E402

from torch_agent_rig import HANDSHAKE_SETS, HandshakeSide  # noqa: E402
from torch_agent_rig import hash_map, to_agent  # noqa: E402

C_CORE = ("core", 2, range(50, 75))
SETS = HANDSHAKE_SETS + [C_CORE]
TRACE = re.compile(r'"[0-9a-f]{16}"')
GIB = 1 << 30


def readings(side, t0):
    """(label, now, card duties, usage report of c as (duty, ts) or None,
    telemetry failures): the sequence both sides sample."""
    return [
        ("shared card", t0, {2: 60, 1: 90}, None, ()),
        ("fresh report", t0 + 10, {2: 80, 1: 90}, (50, t0 + 9), ()),
        ("stale report", t0 + 20, {2: 80, 1: 90}, (50, t0 - 100), ()),
        ("future report", t0 + 30, {2: 80, 1: 90}, (50, t0 + 1000), ()),
        ("over 1", t0 + 40, {2: 100, 1: 100}, None, ()),
        ("over 2", t0 + 50, {2: 100, 1: 100}, None, ()),
        ("over 3", t0 + 60, {2: 100, 1: 100}, None, ()),
        ("over 4", t0 + 70, {2: 100, 1: 100}, None, ()),
        ("fail 1", t0 + 80, {2: 40, 1: 40}, None, (3,)),
        ("fail 2", t0 + 90, {2: 40, 1: 40}, None, (3,)),
        ("fail 3", t0 + 100, {2: 40, 1: 40}, None, (3,)),
        ("back within", t0 + 110, {2: 40, 1: 40}, None, (3,)),
        ("telemetry gone", t0 + 120, {2: 40, 1: 40}, None, ()),
    ]


def run(port, hashes, caplog):
    side = HandshakeSide(port)
    side.admit("c", "2", uid="uid-c")
    side.bind("core", "c", 2, range(50, 75))
    s = side.hs.sampler
    side.node.gen.plugin._config.sampler = s
    op = side.node.gen.operator
    t0 = side.clock.time()
    trace = []
    logger = (sampler if port else agent_sampler).logger.name
    try:
        h_b = side.hash(*HANDSHAKE_SETS[2])
        telemetry.write_flight_summary(side.node.alloc_dir, h_b, 1234.5,
                                       ttft_p50_s=0.25, ts=t0 + 55)
        for label, now, duty, report, failing in readings(side, t0):
            op.set_utilization(duty, {k: v * GIB // 100
                                      for k, v in duty.items()})
            if failing:
                op.fail_utilization(failing)
            if report is not None:
                telemetry.write_usage_report(
                    side.node.alloc_dir, side.hash(*C_CORE), report[0],
                    ts=report[1])
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger=logger):
                join = s.sample_once(now=now)
            records = [json.loads(r.getMessage()) for r in caplog.records
                       if r.name == logger and r.getMessage().startswith("{")]
            changed = side.node.gen.plugin.health_once()
            trace.append([label, join, records, changed,
                          sorted(side.node.gen.plugin.core.unhealthy_chips()),
                          sorted(s.unhealthy_chips()), s.chip_windows(now=now),
                          s.pod_windows(now=now), s.utilization_view(),
                          s.allocations_snapshot(), side.hs.samples()])
        bundle = (sampler if port else agent_sampler).build_diagnostics_bundle(
            op, sampler=s, node_name="node-a", storage=side.node.gen.storage)
    finally:
        side.close()
    text = json.dumps(to_agent(trace, hashes if port else {}))
    return json.loads(TRACE.sub('"<trace>"', text)), bundle


def test_sampler_sequence_matches_the_agents(caplog):
    hashes = hash_map(SETS)
    port, port_bundle = run(True, hashes, caplog)
    agent, agent_bundle = run(False, hashes, caplog)
    assert [t[0] for t in port] == [t[0] for t in agent]
    for p, a in zip(port, agent):
        assert p == a, p[0]
    t = {row[0]: row[1:] for row in port}

    def used(label, pod):
        return t[label][0]["pods"][f"default/{pod}"]["used_percent"]

    # proportional on card 2 (a 50, c 25 of 75 granted), sole on card 1
    assert (used("shared card", "a"), used("shared card", "c"),
            used("shared card", "b")) == (40.0, 20.0, 90.0)
    # c's fresh report wins and a gets the rest of card 2
    assert (used("fresh report", "c"), used("fresh report", "a")) == (
        50.0, 30.0)
    for label in ("stale report", "future report"):
        assert used(label, "c") == pytest.approx(80 * 25 / 75, abs=1e-3)
    # a at 66.7% of a 50% grant and c at 33.3% of 25%: one episode each
    # after three samples; b at 100% of 100% is within its grant
    episodes = [t[f"over {i}"][1] for i in range(1, 5)]
    assert [len(e) for e in episodes] == [0, 0, 2, 0]
    assert [(r["kind"], r["pod"], r["trace_id"]) for r in episodes[2]] == [
        ("tpu_overcommit", "default/a", "<trace>"),
        ("tpu_overcommit", "default/c", "<trace>")]
    assert t["over 4"][0]["pods"]["default/a"]["overcommit"]
    assert not t["back within"][0]["pods"]["default/a"]["overcommit"]
    # card 3 flagged on the third failure, then released
    assert [t[f"fail {i}"][4] for i in (1, 2, 3)] == [[], [], [3]]
    assert t["fail 3"][2] is True and t["fail 3"][3] == [3]
    assert t["telemetry gone"][3] == [] and t["telemetry gone"][4] == []
    snap = t["over 4"][8]
    assert snap["sampler"]["overcommit_episodes"] == 2
    b_row = [p for p in snap["pods"] if p["pod"] == "default/b"][0]
    assert (b_row["tokens_per_s"], b_row["ttft_p50_s"]) == (1234.5, 0.25)
    windows = t["telemetry gone"][5]["2"]
    assert windows["1m"]["samples"] == 7 and windows["5m"]["samples"] == 13
    assert t["over 3"][9][
        "elastic_tpu_overcommit_detected_total{}"] == 2
    for validate in (sampler.validate_bundle, agent_sampler.validate_bundle):
        assert validate(port_bundle) == [] and validate(agent_bundle) == []
    assert sampler.validate_bundle({"kind": "x"})[0].startswith("kind must")


def test_a_malformed_bundle_is_refused_as_the_agent_refuses_it():
    bad = {"kind": sampler.BUNDLE_KIND, "version": 0, "generated_ts": "x",
           "node": 1, "devices": [{"index": 0}, 3],
           "healthy_indexes": [0, "1"], "health_reasons": [],
           "error_counters": {}, "allocations": {
               "chips": [], "pods": [{"pod": "a"}],
               "drain": {"state": "melting", "trigger": "", "drains_total": 0,
                         "stamped_pods": "a"},
               "migration": {"early_reclaims_total": 1.5,
                             "records_published_total": 0,
                             "completed_total": 0, "acked_pods": []},
               "slices": {"s31": {"hosts": ["h0"], "epoch": 1}, "t": 3}},
           "sampler_windows": {"chips": {}, "pods": []}, "traces": {},
           "agent": {}, "memory": {"rss_bytes": "x"},
           "timeline": {"events": [{"seq": 2}, {"seq": 1}],
                        "total_events": 2},
           "latency": {"bind": {"phases": {"x": {"count": 1}}}},
           "requests": {"classes": {"c": []}, "conservation": 1},
           "profile": {"top": 1}, "subsystems": {"gc": {"state": "x"}},
           "reconcile": {"open_intents": [{"pod": "a"}]}}
    assert sampler.validate_bundle(bad) == agent_sampler.validate_bundle(bad)
    assert len(sampler.validate_bundle(bad)) > 25
