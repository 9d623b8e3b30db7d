"""The port's goodput ledger (``goodput.py``) against the agent's.

- ``replay_goodput`` of both packages gives equal results on the same
  journal: the rows the repartition scripts of
  ``tests/test_torch_repartition.py`` write (grows, throttles, an
  ack-gated eviction with its record, a deadline eviction, opt-outs), and
  a handshake's (``tests/test_torch_migration.py``'s drain, early
  reclaim, replacement and verified resume) with an agent restart after a
  crash window.
- Seeded random histories (numpy) written through the port's timeline
  into a small ring: ``verify_conservation`` finds nothing on either
  side, and both replays are equal, anchors included.
- ``select_pods``, ``build_goodput_block`` (on the same db, opened by each
  package's store) and ``validate_goodput_block`` (on good and broken
  blocks) answer as the agent's.
- ``GoodputLedger``: ticks export the same goodput-ratio and downtime
  samples, the anchors journaled under ``agent_state`` key ``goodput``
  carry a pod's start across a restart whose ring trimmed its bind rows,
  and ``/debug/goodput`` answers as the agent's.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from prometheus_client import CollectorRegistry, generate_latest  # noqa: E402

from elastic_tpu_agent import goodput as agent_goodput  # noqa: E402
from elastic_tpu_agent import metrics as agent_metrics  # noqa: E402
from elastic_tpu_agent import timeline as agent_timeline  # noqa: E402
from elastic_tpu_agent.common import ManualClock as AgentClock  # noqa: E402
from elastic_tpu_agent.storage import Storage as AgentStorage  # noqa: E402
from elastic_tpu_agent_torch import goodput, metrics  # noqa: E402
from elastic_tpu_agent_torch import timeline as tl  # noqa: E402
from elastic_tpu_agent_torch.common import ManualClock  # noqa: E402
from elastic_tpu_agent_torch.storage import Storage  # noqa: E402

import test_torch_migration as mig_tests  # noqa: E402
import test_torch_repartition as rep_tests  # noqa: E402
from torch_agent_rig import HandshakeSide, RepartitionSide  # noqa: E402


def replay_both(rows, asof, anchors=None, acks=None):
    """Both packages' replays of the same rows; they must be equal, and
    conserve every pod's lifetime with causes that resolve in ``rows``."""
    port = goodput.replay_goodput(rows, asof, anchors=anchors, acks=acks)
    agent = agent_goodput.replay_goodput(rows, asof, anchors=anchors,
                                         acks=acks)
    assert port == agent
    assert goodput.verify_conservation(port, rows) == []
    assert agent_goodput.verify_conservation(agent, rows) == []
    return port


REP_SCRIPTS = ["ack_evict", "silence", "throttle_lift", "opt_out",
               "peer_departs"]


@pytest.mark.parametrize("name", REP_SCRIPTS)
def test_replays_of_a_repartition_journal_are_equal(name):
    side = RepartitionSide(True, annotations=rep_tests.OPTIONS.get(name))
    try:
        rep_tests.SCRIPTS[name](side, lambda label, value: None)
        side.clock.advance(5)
        rows = side.node.gen.storage.timeline_rows()
        result = replay_both(rows, side.clock.time())
    finally:
        side.close()
    o = result["pods"].get("default/o")
    if name == "ack_evict":
        # the first o (its bind's rows, and its record, eviction and
        # reclaim, each share one instant of the clock): its ack's
        # checkpoint priced to the throttle; then a second life from the
        # replay of the re-created pod
        states = [i["state"] for i in o["intervals"]]
        assert states == ["productive", "checkpointing", "productive"]
        (ck,) = [i for i in o["intervals"] if i["state"] == "checkpointing"]
        assert ck["cause"]["category"] == "qos_throttle"
        assert o["live"] and result["downtime_by_cause"]["qos_throttle"] > 0
    elif name == "silence":
        # throttled until the deadline (the evict window closes at the
        # same instant of the clock)
        assert not o["live"] and o["states"]["throttled"] > 300
        assert result["downtime_by_cause"]["qos_throttle"] > 300
    elif name == "throttle_lift":
        assert [i["state"] for i in o["intervals"]][-2:] == [
            "throttled", "productive"]


def test_replays_of_a_handshake_journal_are_equal(tmp_path):
    """The migration tests' drain, early reclaim, replacement and verified
    resume, then a crash window closed by an agent restart."""
    side = HandshakeSide(True)
    try:
        mig_tests.resume("ok")(side, lambda label, value: None)
        side.clock.advance(30)
        side.node.gen.timeline.emit(tl.KIND_AGENT_STARTED, boot_id="b2")
        side.clock.advance(5)
        rows = side.node.gen.storage.timeline_rows()
        acks = side.hs.migration.acked_pods()
        result = replay_both(rows, side.clock.time(), acks=acks)
    finally:
        side.close()
    a = result["pods"]["default/a"]
    assert {"checkpointing", "migrating", "unattributed"} <= {
        i["state"] for i in a["intervals"]}
    assert result["downtime_by_cause"]["operator_drain"] > 0
    assert result["migrations"] and result["migrations"][0]["pod"] == (
        "default/a")


def _random_history(seed):
    """A node history through the port's timeline into a small ring: pods
    bind (some stay queued), drains, throttles, migrations, reforms,
    reclaims and agent restarts after crash windows, in a seeded order."""
    rng = np.random.default_rng(seed)
    clock = ManualClock()
    store = Storage(":memory:")
    t = tl.Timeline(store, node_name="n0",
                    cap=int(rng.choice([6, 12, 40, 500])), clock=clock)
    pods = [f"d/p{i}" for i in range(int(rng.integers(1, 6)))]
    for pod in pods:
        if rng.random() < 0.8:
            t.emit(tl.KIND_BIND_INTENT, keys={"pod": pod})
            clock.advance(float(rng.uniform(0, 2)))
        if rng.random() < 0.9:
            t.emit(tl.KIND_BIND_COMMIT, keys={"pod": pod})
        clock.advance(float(rng.uniform(0, 3)))
    for _ in range(int(rng.integers(5, 40))):
        clock.advance(float(rng.uniform(0, 5)))
        roll, pod = rng.random(), pods[int(rng.integers(len(pods)))]
        if roll < 0.15:
            t.emit(tl.KIND_DRAIN_TRANSITION, state="draining", trigger=str(
                rng.choice(["maintenance:x", "preemption:spot", "operator"])))
        elif roll < 0.25:
            t.emit(tl.KIND_DRAIN_TRANSITION, state="active", trigger="")
        elif roll < 0.40:
            t.emit(tl.KIND_THROTTLE, keys={"pod": pod}, action=str(
                rng.choice(["throttle", "unthrottle", "evict"])))
        elif roll < 0.55:
            action = str(rng.choice(["recorded", "early_reclaim",
                                     "restore_stamped", "completed"]))
            extra = ({"mode": "precopy",
                      "cutover_ts": clock.time() - float(rng.uniform(0, 3))}
                     if action == "recorded" and rng.random() < 0.3 else {})
            t.emit(tl.KIND_MIGRATION, keys={"pod": pod}, action=action,
                   **extra)
        elif roll < 0.65:
            t.emit(tl.KIND_SLICE_REFORMED, keys={"pod": pod, "slice": "S"},
                   epoch=1)
        elif roll < 0.75:
            t.emit(tl.KIND_POD_RECLAIMED, keys={"pod": pod})
        elif roll < 0.85:
            clock.advance(float(rng.uniform(0, 20)))
            t.emit(tl.KIND_AGENT_STARTED, boot_id=f"b{seed}")
        else:
            t.emit(tl.KIND_BIND_COMMIT, keys={"pod": pod})
    anchors = {}
    if rng.random() < 0.5:
        anchors = {"node": "n0", "pods": {pods[0]: {"start": 999_999_990.0}},
                   "last_alive_ts": clock.time() - float(rng.uniform(0, 5))}
    acks = {pods[-1]: clock.time() - 1.0} if rng.random() < 0.5 else {}
    clock.advance(float(rng.uniform(0, 5)))
    rows = store.timeline_rows()
    store.close()
    return rows, clock.time(), anchors, acks


@pytest.mark.parametrize("seed", range(12))
def test_random_histories_conserve_on_both_sides(seed):
    rows, asof, anchors, acks = _random_history(seed)
    replay_both(rows, asof, anchors=anchors, acks=acks)


@pytest.mark.parametrize("filters", [
    {}, {"pod": "d/p1"}, {"pod": "p0"}, {"slice_id": "S"},
    {"since": 1_000_000_030.0}])
def test_select_pods_matches_the_agents(filters):
    rows, asof, anchors, acks = _random_history(3)
    result = replay_both(rows, asof, anchors=anchors, acks=acks)
    assert goodput.select_pods(result, **filters) == (
        agent_goodput.select_pods(result, **filters))


def _ledger_db(path):
    """A port db with a pod bound, throttled and evicted, and another
    live, with the ledger's anchors journaled by a tick."""
    clock = ManualClock()
    store = Storage(path)
    t = tl.Timeline(store, node_name="n0", clock=clock)
    for pod in ("d/a", "d/b"):
        t.emit(tl.KIND_BIND_INTENT, keys={"pod": pod})
        clock.advance(1)
        t.emit(tl.KIND_BIND_COMMIT, keys={"pod": pod})
    clock.advance(10)
    t.emit(tl.KIND_THROTTLE, keys={"pod": "d/a"}, action="throttle")
    clock.advance(4)
    t.emit(tl.KIND_THROTTLE, keys={"pod": "d/a"}, action="evict")
    t.emit(tl.KIND_RECONCILE_REPAIR, keys={"pod": "d/a"},
           **{"class": "reclaimed_pod"})
    clock.advance(6)
    goodput.GoodputLedger(store, node_name="n0", clock=clock).tick()
    store.close()


@pytest.mark.parametrize("filters", [{}, {"pod": "d/a"}, {"pod": "b"},
                                     {"since": 2_000_000_000.0}])
def test_the_block_from_one_db_matches_the_agents(tmp_path, filters):
    db = str(tmp_path / "meta.db")
    _ledger_db(db)
    with Storage(db) as store:
        port = goodput.build_goodput_block(store, **filters)
    with AgentStorage(db) as store:
        agent = agent_goodput.build_goodput_block(store, **filters)
    assert port == agent
    assert port["conservation_problems"] == []
    assert goodput.validate_goodput_block(port) == []
    if not filters:
        assert port["anchored_pods"] == 1        # d/b, still live
        a = port["pods"]["d/a"]
        assert [i["state"] for i in a["intervals"]] == [
            "queued", "productive", "throttled"]
        assert port["downtime_by_cause"] == {
            "bind_queue": 2.0, "qos_throttle": 4.0}


BROKEN = [
    "not a block",
    {"pods": {}},
    {"asof": 1.0, "pods": [], "downtime_by_cause": {}},
    {"asof": 1.0, "pods": {"d/a": {"intervals": [{"state": "idle",
                                                 "start": 0, "end": "x"}],
                                   "states": {}}},
     "downtime_by_cause": {"coffee": "1"}},
]


@pytest.mark.parametrize("block", range(len(BROKEN)))
def test_validate_goodput_block_matches_the_agents(block):
    got = goodput.validate_goodput_block(BROKEN[block])
    assert got and got == agent_goodput.validate_goodput_block(BROKEN[block])


def _ledger_side(port, root):
    """A side's store, timeline (cap 6: the ring trims), ledger and
    AgentMetrics on its own registry, on its clock."""
    clock = (ManualClock if port else AgentClock)()
    store = (Storage if port else AgentStorage)(os.path.join(
        root, f"{'port' if port else 'agent'}.db"))
    t = (tl if port else agent_timeline).Timeline(
        store, node_name="n0", cap=6, clock=clock)
    reg = CollectorRegistry()
    m = (metrics if port else agent_metrics).AgentMetrics(registry=reg)
    ledger = (goodput if port else agent_goodput).GoodputLedger(
        store, node_name="n0", metrics=m, clock=clock)
    return dict(clock=clock, store=store, t=t, reg=reg, m=m, ledger=ledger)


def _samples(reg):
    text = generate_latest(reg).decode()
    return sorted(line for line in text.splitlines()
                  if line.startswith(("elastic_tpu_goodput_ratio",
                                      "elastic_tpu_downtime")))


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def ledger_story(port, root):
    s = _ledger_side(port, root)
    clock, t, ledger = s["clock"], s["t"], s["ledger"]
    out = {}
    try:
        t.emit(tl.KIND_BIND_INTENT, keys={"pod": "d/a"})
        clock.advance(2)
        t.emit(tl.KIND_BIND_COMMIT, keys={"pod": "d/a"})
        clock.advance(5)
        t.emit(tl.KIND_THROTTLE, keys={"pod": "d/a"}, action="throttle")
        clock.advance(3)
        ledger.tick()
        out["first"] = ledger.status()
        out["samples"] = _samples(s["reg"])
        # the ring trims a's bind rows; a restarted ledger's replay keeps
        # its start from the journaled anchor
        for i in range(8):
            clock.advance(1)
            t.emit(tl.KIND_CORDON, cordoned=bool(i % 2))
        restarted = (goodput if port else agent_goodput).GoodputLedger(
            s["store"], node_name="n0", metrics=s["m"], clock=clock)
        restarted.resume()
        clock.advance(1)
        restarted.tick()
        out["restarted"] = restarted.status(pod="a")
        out["samples_after"] = _samples(s["reg"])
        s["m"].attach_goodput(restarted)
        s["m"].serve(0)
        out["endpoint"] = [
            _get(s["m"].http_port, p) for p in (
                "/debug/goodput", "/debug/goodput?pod=d/a&since=5",
                "/debug/goodput?since=x")]
        return out
    finally:
        s["m"].close()
        s["store"].close()


def test_the_ledger_exports_and_resumes_as_the_agents(tmp_path):
    port = ledger_story(True, str(tmp_path))
    agent = ledger_story(False, str(tmp_path))
    assert port == agent
    first = port["first"]
    assert first["pods"]["d/a"]["states"]["throttled"] == 3.0
    assert first["conservation_problems"] == []
    restarted = port["restarted"]
    assert restarted["anchored_pods"] == 1
    a = restarted["pods"]["d/a"]
    # the anchor keeps a's start; the trimmed bind and throttle rows
    # leave the rest productive
    assert a["lifetime_s"] == 19.0 and a["anchored"]
    assert [code for code, _ in port["endpoint"]] == [200, 200, 400]
    assert 'elastic_tpu_downtime_seconds_total{cause="qos_throttle"} 3.0' \
        in port["samples"]
