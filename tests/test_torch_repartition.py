"""The port's repartition controller (``repartition.py``) against the
agent's, and the pod side's answer to a throttle.

Each side runs on ``tests/torch_agent_rig.py`` (``RepartitionSide``: pods
d and b (high priority, 40 and 20 gpu-core units and a quarter of the
memory each), o and l (low, 10 and 20 units) on card 0, each opted into
repartitioning; the side's sampler, migration coordinator and controller
on its ``ManualClock``). One script of usage reports, sampler passes and
``tick()`` calls runs on both sides, and after every step the
controller's status, each spec's quota and throttle env, the records, the
Events, the samples and the timeline rows must be equal once names and
hashes are mapped:

- ``grow``: d idle and b busy move 10 units d -> b, and no more;
  ``effective_grant``: b busy at its grown quota grows again, and the
  sampler's overcommit alarm judges it by the grown grant;
- ``donor_pressure`` and ``borrower_idle`` unwind that edge;
- ``peer_departs``: b leaves the node and the edge unwinds;
- ``precedence``: high d never donates to low l; idle low l donates to
  busy high b;
- ``self_cap``: b's ``qos-core-units`` cap bounds its growth;
- ``frozen_view``: ticks on a sampler view that did not advance accrue
  no streak;
- ``throttle_lift``: three fresh over-quota reports throttle o, a
  compliant one lifts it; ``silence``: a throttled o that stops reporting
  stays throttled and is evicted at the deadline, with no record;
- ``ack_evict``: a throttled o's checkpoint ack evicts it at once, its
  MigrationRecord (``qos_evict``) published first; the kubelet's
  still-listed assignment is not replayed until o is re-created under
  the same name, which starts clean;
- ``opt_out``: o throttled and b borrowing both opt out: the throttle
  lifts and the edge unwinds.

Crash points: a fault that raises at ``repartition.pre_journal``,
``.post_journal``, ``.mid_restamp``, ``restamp.spec_file`` or
``.pre_evict_reclaim``, then a restart (a new generation over the same db)
whose controller resumes: both sides converge to the same quotas and
suppression. The journal is the agent's shape: the port's controller
resumes the agent's journal, and the reverse.

The port's runner, stamped with a throttle, checkpoints, acks once the
save is durable and trains on.
"""

import json
import os
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent_torch.workloads import data as tdata  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle  # noqa: E402
from elastic_tpu_agent_torch.workloads import runner as trunner  # noqa: E402

from torch_agent_rig import (  # noqa: E402
    REP_PODS,
    REP_SETS,
    Node,
    RepartitionSide,
    hash_map,
    to_agent,
)

QUIET = {"d": 2.0, "b": 2.0}
GROW = {"d": 2.0, "b": 19.0}


def grow(side, step):
    step("grown", side.cycle(GROW))
    step("steady", side.cycle(GROW))


def effective_grant(side, step):
    grow(side, step)
    for i in range(3):
        step(f"busy {i}", side.cycle({"d": 2.0, "b": 28.0}))


def donor_pressure(side, step):
    grow(side, step)
    step("donor busy", side.cycle({"d": 28.0, "b": 19.0}))


def borrower_idle(side, step):
    grow(side, step)
    step("borrower idle", side.cycle(QUIET))


def peer_departs(side, step):
    grow(side, step)
    side.exit_pod("b")
    step("b gone", side.cycle({"d": 2.0}))


def precedence(side, step):
    step("high to low", side.cycle({"d": 2.0, "l": 19.0, "b": 10.0}))
    step("low to high", side.cycle({"d": 30.0, "l": 3.0, "b": 19.0}))


def self_cap(side, step):
    step("capped", side.cycle(GROW))
    step("at the cap", side.cycle({"d": 2.0, "b": 24.0}))


def frozen_view(side, step):
    step("fresh", side.cycle({"o": 30.0}))
    for i in range(4):
        step(f"frozen {i}", side.cycle({"o": 30.0}, sample=False))
    for i in range(2):
        step(f"fresh {i}", side.cycle({"o": 30.0}))


def _throttle(side, step, extra=None):
    for i in range(3):
        step(f"over {i}", side.cycle({"o": 30.0, **(extra or {})}))


def throttle_lift(side, step):
    _throttle(side, step)
    step("compliant", side.cycle({"o": 8.0}))


def silence(side, step):
    _throttle(side, step)
    os.unlink(os.path.join(side.node.alloc_dir, "usage",
                           f"{side.core_hash('o')}.json"))
    step("silent", side.cycle({}))
    side.clock.advance(300)
    step("deadline", side.cycle({}))
    step("replay", _replays(side))


def ack_evict(side, step):
    _throttle(side, step)
    assert lifecycle.write_checkpoint_ack(
        side.node.alloc_dir, side.core_hash("o"), 42,
        checkpoint_dir="/ckpt/o", signal="overcommit",
        ts=side.clock.time() + 0.5)
    side.clock.advance(1)
    side.hs.migration.tick()
    step("acked", side.cycle({"o": 30.0}))
    step("no replay", _replays(side))
    side.admit("o", "0", uid="uid-o2")     # deleted and re-created
    side.annotate("o", {"elasticgpu.io/repartition": "true",
                        "elasticgpu.io/qos-priority": "low"})
    step("re-created", side.cycle({}))
    step("replayed", _replays(side))
    step("clean", side.cycle({"o": 8.0}))


def _replays(side):
    """Binds replayed over two reconcile passes: a divergence is repaired
    on its second sighting."""
    return sum(side.node.gen.reconciler.reconcile_once()["replayed_binds"]
               for _ in range(2))


def opt_out(side, step):
    grow(side, step)
    _throttle(side, step, GROW)
    for pod in ("o", "b"):
        side.annotate(pod, {"elasticgpu.io/repartition": "false"})
    step("opted out", side.cycle({"o": 30.0, **GROW}))


SCRIPTS = {f.__name__: f for f in (
    grow, effective_grant, donor_pressure, borrower_idle, peer_departs,
    precedence,
    self_cap, frozen_view, throttle_lift, silence, ack_evict, opt_out)}
OPTIONS = {"self_cap": {"b": {"elasticgpu.io/qos-core-units": "25"}}}
HASHES = hash_map(REP_SETS)


def run(name, port):
    side = RepartitionSide(port, annotations=OPTIONS.get(name))
    trace = []

    def step(label, value):
        trace.append(to_agent([label, value, side.snapshot()],
                              HASHES if port else {}))

    try:
        SCRIPTS[name](side, step)
        return trace
    finally:
        side.close()


def _core(pod):
    """The agent's core hash of ``pod``: traces carry the agent's names."""
    names = Node.__new__(Node)
    names.port = False
    kind, chip, units = REP_SETS[REP_PODS[pod][1][0]]
    return names.device(kind, names.ids(kind, chip, units)).hash


def _units(snap, pod):
    """The pod's stamped core units (``snap``: a snapshot, or its
    quotas)."""
    quotas = snap.get("quotas", snap)
    return int(quotas[f"{_core(pod)}.json"]["ELASTIC_TPU_CORE_UNITS"])


def _edges(snap):
    return [(e["donor"], e["borrower"], e["core_units"])
            for e in snap["status"]["edges"]]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_repartition_script_matches_the_agents(name):
    port, agent = run(name, True), run(name, False)
    assert [t[0] for t in port] == [t[0] for t in agent]
    for p, a in zip(port, agent):
        assert p == a, p[0]
    CHECKS[name]({t[0]: t[1:] for t in port})


def _grow(t):
    result, snap = t["grown"]
    assert result["grown"] == 1
    assert _edges(snap) == [("default/d", "default/b", 10)]
    assert (_units(snap, "d"), _units(snap, "b")) == (30, 30)
    edge = snap["status"]["edges"][0]
    assert edge["hbm_bytes"] > 0           # the donor's core:memory ratio
    assert ("default/b", "TPURepartitioned") in map(tuple, snap["events"])
    assert snap["samples"][
        "elastic_tpu_repartitions_total{direction=grow}"] == 1
    rows = [r for r in snap["timeline"] if r[0] == "repartition"]
    assert sorted(r[2]["role"] for r in rows) == ["borrower", "donor"]
    assert t["steady"][0]["grown"] == 0


def _effective(t):
    """28% of a grown 30 units is within the grant + 5 the sampler judges
    by, not over the base 20's; a second step grows it to 40."""
    _grow(t)
    snap = t["busy 2"][1]
    assert snap["samples"]["elastic_tpu_overcommit_detected_total{}"] == 0
    assert _edges(snap) == [("default/d", "default/b", 20)]
    assert (_units(snap, "d"), _units(snap, "b")) == (20, 40)


def _shrink(label):
    def check(t):
        _grow(t)
        result, snap = t[label]
        assert result["shrunk"] == 1 and not _edges(snap)
        assert (_units(snap, "d"), _units(snap, "b")) == (40, 20)
        assert snap["samples"][
            "elastic_tpu_repartitions_total{direction=shrink}"] == 1
    return check


def _peer(t):
    _grow(t)
    result, snap = t["b gone"]
    assert result["shrunk"] == 1 and not _edges(snap)
    assert _units(snap, "d") == 40
    (row,) = [r for r in snap["timeline"] if r[0] == "repartition"
              and r[2]["direction"] == "shrink" and r[2]["role"] == "donor"]
    assert row[2]["reason"] == "peer gone: default/b"


def _precedence(t):
    result, snap = t["high to low"]
    assert result["grown"] == 0 and not _edges(snap)
    result, snap = t["low to high"]
    assert _edges(snap) == [("default/l", "default/b", 10)]


def _cap(t):
    result, snap = t["capped"]
    assert _edges(snap) == [("default/d", "default/b", 5)]
    assert _units(snap, "b") == 25
    assert t["at the cap"][0]["grown"] == 0


def _frozen(t):
    for i in range(4):
        assert t[f"frozen {i}"][0]["throttled"] == 0
    assert t["fresh 0"][0]["throttled"] == 0
    result, snap = t["fresh 1"]
    assert result["throttled"] == 1
    assert snap["status"]["throttles_total"] == 1


def _throttled(t):
    result, snap = t["over 2"]
    assert result["throttled"] == 1
    assert list(snap["status"]["throttled_pods"]) == ["default/o"]
    env = snap["quotas"][f"{_core('o')}.json"]
    assert env["ELASTIC_TPU_THROTTLE"] == "overcommit"
    assert int(env["ELASTIC_TPU_THROTTLE_DEADLINE"]) == int(
        snap["status"]["throttled_pods"]["default/o"]["deadline_ts"])
    assert ("default/o", "TPUThrottled") in map(tuple, snap["events"])
    assert snap["samples"]["elastic_tpu_throttles_total{}"] == 1


def _lift(t):
    _throttled(t)
    snap = t["compliant"][1]
    assert not snap["status"]["throttled_pods"]
    env = snap["quotas"][f"{_core('o')}.json"]
    assert "ELASTIC_TPU_THROTTLE" not in env
    actions = [r[2]["action"] for r in snap["timeline"] if r[0] == "throttle"]
    assert actions == ["throttle", "unthrottle"]


def _silence(t):
    _throttled(t)
    assert t["silent"][1]["status"]["throttled_pods"]
    result, snap = t["deadline"]
    assert result["evicted"] == 1
    assert snap["status"]["evicted_pods"] == ["default/o"]
    assert "default/o" not in snap["records"]
    assert snap["samples"]["elastic_tpu_qos_evictions_total{}"] == 1
    assert ("default/o", "TPUQoSEvicted") in map(tuple, snap["events"])
    assert not [r for r in snap["timeline"] if r[0] == "migration"]
    assert t["replay"][0] == 0


def _ack(t):
    _throttled(t)
    result, snap = t["acked"]
    assert result["evicted"] == 1
    assert snap["status"]["evicted_pods"] == ["default/o"]
    rows = [(r[0], r[2].get("action")) for r in snap["timeline"]
            if r[1] == "default/o" and r[0] in ("migration", "throttle")]
    # the record first, then the eviction
    assert rows[-3:] == [("migration", "recorded"),
                         ("migration", "record_published"),
                         ("throttle", "evict")]
    recorded = [r for r in snap["timeline"] if r[0] == "migration"]
    assert {r[2]["reason"] for r in recorded} == {"qos_evict"}
    assert recorded[0][2]["step"] == 42
    assert t["no replay"][0] == 0
    assert not t["re-created"][1]["status"]["evicted_pods"]
    assert t["replayed"][0] == 1
    snap = t["clean"][1]
    assert "default/o" in snap["records"]
    assert not snap["status"]["throttled_pods"]


def _opt_out(t):
    _grow(t)
    result, snap = t["opted out"]
    assert not snap["status"]["throttled_pods"] and not _edges(snap)
    assert result["shrunk"] == 1
    assert (_units(snap, "d"), _units(snap, "b")) == (40, 20)


CHECKS = {"grow": _grow, "effective_grant": _effective,
          "donor_pressure": _shrink("donor busy"),
          "borrower_idle": _shrink("borrower idle"), "peer_departs": _peer,
          "precedence": _precedence, "self_cap": _cap,
          "frozen_view": _frozen, "throttle_lift": _lift,
          "silence": _silence, "ack_evict": _ack, "opt_out": _opt_out}


# -- crash points -------------------------------------------------------------

CRASHES = {
    "repartition.pre_journal": "grow",
    "repartition.post_journal": "grow",
    "repartition.mid_restamp": "grow",
    "restamp.spec_file": "grow",
    "repartition.pre_evict_reclaim": "evict",
}


def crash_run(point, port):
    """The move (a grow, or an ack-gated eviction) with ``point`` raising
    once, then a restart: a new generation over the same db whose
    controller resumes, and one more pass."""
    side = RepartitionSide(port)
    try:
        if CRASHES[point] == "evict":
            for _ in range(3):
                side.cycle({"o": 30.0})
            assert lifecycle.write_checkpoint_ack(
                side.node.alloc_dir, side.core_hash("o"), 7,
                checkpoint_dir="/ckpt/o", ts=side.clock.time() + 0.5)
            side.clock.advance(1)
            side.hs.migration.tick()
            reports = {"o": 30.0}
        else:
            reports = GROW
        raised = False
        with side.faults.armed(point, "raise-once"):
            try:
                side.cycle(reports)
            except side.faults.FaultError:
                raised = True
        torn = side.quotas()
        side.boot()
        side.rep.resume()
        resumed = side.quotas()
        replayed = _replays(side)
        side.hs.sampler.sample_once(now=side.clock.time())
        side.rep.tick()
        return to_agent(dict(
            raised=raised, torn=torn, resumed=resumed, replayed=replayed,
            final=side.snapshot()), HASHES if port else {})
    finally:
        side.close()


@pytest.mark.parametrize("point", sorted(CRASHES))
def test_a_crash_converges_as_the_agents(point):
    port, agent = crash_run(point, True), crash_run(point, False)
    assert port == agent
    # restamp.spec_file's fault is absorbed (the restamp is owed to the
    # next pass); the others leave the tick
    assert port["raised"] is (point != "restamp.spec_file")
    final = port["final"]
    if CRASHES[point] == "evict":
        # the eviction was journaled before the teardown: suppression
        # stays armed across the restart and the throttle is spent; the
        # bindings the crash kept wait for the next escalation
        assert final["status"]["evicted_pods"] == ["default/o"]
        assert not final["status"]["throttled_pods"]
        assert port["replayed"] == 0
        return
    assert _edges(final) == [("default/d", "default/b", 10)]
    assert not final["status"]["pending_restamp"]
    assert (_units(final, "d"), _units(final, "b")) == (30, 30)
    if point == "repartition.pre_journal":
        # nothing was journaled: the restart resumes the grants, and the
        # next pass makes the move again
        assert (_units(port["resumed"], "d"), _units(
            port["resumed"], "b")) == (40, 20)
    else:
        # the journaled move is re-asserted by resume() alone
        assert port["resumed"] == final["quotas"]


@pytest.mark.parametrize("writer", ["agent", "port"])
def test_either_controller_resumes_the_others_journal(writer):
    """A grow and a throttle journaled by one package's controller; the
    other package's controller, on a node with the same pods, resumes the
    journal: the same status (edges, throttles, totals) and quotas."""
    sides = {"port": RepartitionSide(True), "agent": RepartitionSide(False)}
    try:
        src = sides[writer]
        dst = sides["agent" if writer == "port" else "port"]
        src.cycle(GROW)
        for _ in range(3):
            src.cycle({"o": 30.0, **GROW})
        journal = src.node.gen.storage.load_state("repartition")
        assert journal["edges"] and journal["throttles"]
        dst.node.gen.storage.save_state("repartition", journal)
        dst.boot()
        dst.rep.resume()
        got = {name: to_agent(dict(status=s.rep.status(), quotas=s.quotas()),
                              HASHES if s.port else {})
               for name, s in sides.items()}
        for block in (got["port"], got["agent"]):
            block["status"]["last_tick_ts"] = None
        assert got["port"] == got["agent"]
    finally:
        for s in sides.values():
            s.close()


# -- the pod side -------------------------------------------------------------


def test_the_runner_acks_a_throttle_and_trains_on(tmp_path, monkeypatch):
    """A throttle stamped in the pod's spec: the port's runner saves a
    checkpoint, acks it (the agent's reader agrees) once the save is
    durable, and runs its whole step budget."""
    for name in ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
                 "ELASTIC_TPU_TRACE_ID", "ELASTIC_TPU_RESTORE_DIR",
                 "ELASTIC_TPU_RESTORE_STEP", "ELASTIC_TPU_FLIGHT_RECORDER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ELASTIC_TPU_ENV_FILE", str(tmp_path / "no-env"))
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_WAIT_S", "0")
    alloc = tmp_path / "alloc"
    alloc.mkdir()
    (alloc / "h1.json").write_text(json.dumps({"env": {
        "ELASTIC_TPU_THROTTLE": "overcommit",
        "ELASTIC_TPU_THROTTLE_DEADLINE": str(int(time.time()) + 300)}}))
    monkeypatch.setenv("TPU", "h1")
    monkeypatch.setenv("ELASTIC_TPU_ALLOC_DIR", str(alloc))
    data = str(tmp_path / "tokens.bin")
    tdata.write_token_file(data, list(range(2048)) * 8)
    ck = str(tmp_path / "ck")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trunner.main(
            f"--preset tiny --batch 4 --seq 32 --steps 4 --data {data} "
            f"--checkpoint-every 0 --checkpoint-dir {ck}".split(),
            device="cpu")
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and report["steps"] == 4 and not report["preempted"]
    assert report["lifecycle_signal"] is None
    ack = jlc.read_checkpoint_ack(str(alloc), "h1")
    assert (ack["kind"], ack["step"], ack["signal"]) == (
        "checkpoint", 0, "overcommit")
    assert ack["digest"] == jlc.checkpoint_digest(ck)
    assert sorted(os.listdir(ck)) == ["0"]
