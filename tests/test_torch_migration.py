"""The port's migration coordinator (``migration.py``) against the agent's,
and the whole handshake through the port's runner.

Each side runs on ``tests/torch_agent_rig.py`` (``HandshakeSide``: pods a
and b bound, a fake apiserver, the side's drain orchestrator and
coordinator on its ``ManualClock``), and one script of acks, clock
advances and ``tick()`` calls runs on both:

- ``early_reclaim``: a requested drain; a's ack lands after the cordon
  and a is reclaimed at once (b, un-acked, waits), its MigrationRecord is
  published at the apiserver, the reconciler replays neither pod's
  kubelet assignment; b's ack completes the drain as ``drained_acked``;
- ``resume``: a replacement for a (a new uid) binds after the record:
  the restore env is stamped into its specs, a resume ack at or past the
  acked step completes the migration (``TPUMigrationCompleted``, the
  record deleted); ``regress`` and ``world`` first ack a step below the
  acked one or a world of 2, which fails verification once per ack;
- ``precopy``: rounds streamed under the drain, the cutover stamped when
  the delta stops shrinking, the final ack reclaims a with a pre-copy
  record whose digest is a delta chain; the replacement's resume is
  rejected while the chain is torn (a block gone) and verified once it
  is repaired;
- ``qos``: ``publish_record`` of an acked pod without a drain, and of one
  that never acked.

After every step the coordinator's and the drain's status, the specs and
records, the Events, the samples, the timeline rows and the ElasticTPU
objects must be equal once names, hashes and trace ids are mapped.

``test_runner_handshake_on_the_cpu`` runs the port alone: its runner, in
this process, drained by its agent's orchestrator, streaming pre-copy
rounds that the coordinator reads, cut over by it, reclaimed early,
recorded, and resumed by a replacement from the stamped restore env to
the uninterrupted run's loss.
"""

import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from elastic_tpu_agent_torch import migration  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    SYSTEM_CLOCK,
    EnvCutover,
    EnvRestoreDir,
    EnvRestoreStep,
    EnvRestoreTrace,
)
from elastic_tpu_agent_torch.workloads import checkpointing  # noqa: E402
from elastic_tpu_agent_torch.workloads import data as tdata  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle  # noqa: E402
from elastic_tpu_agent_torch.workloads import runner as trunner  # noqa: E402

from torch_agent_rig import (  # noqa: E402
    HANDSHAKE_SETS,
    HandshakeSide,
    hash_map,
    to_agent,
)

A_CORE = HANDSHAKE_SETS[0]
B_CORE = HANDSHAKE_SETS[2]
TRACE = re.compile(r'"[0-9a-f]{16}"')
CRD = "/apis/elasticgpu.io/v1alpha1/elastictpus"


def ack(side, dev, step, kind="checkpoint", after=1.0, **kw):
    """The pod's ack (the pod side's writer) ``after`` seconds on the
    side's clock."""
    kw.setdefault("checkpoint_dir", "/ckpt/" + kind)
    kw.setdefault("digest", "d" * 32)
    assert lifecycle.write_checkpoint_ack(
        side.node.alloc_dir, side.hash(*dev), step, kind=kind,
        ts=side.clock.time() + after, **kw)


def restore_env(side, dev):
    spec = side.node.gen.plugin.core.read_alloc_spec(side.hash(*dev)) or {}
    return {k: v for k, v in spec.get("env", {}).items()
            if k in (EnvRestoreDir, EnvRestoreStep, EnvRestoreTrace,
                     EnvCutover)}


def objects(side):
    """The ElasticTPU objects at the side's apiserver."""
    return {o["metadata"]["name"]: o for o in
            side.hs.kube._get(CRD).json().get("items", [])}


def early_reclaim(side, step):
    side.hs.drain.request_drain()
    step("draining", side.hs.drain.tick())
    ack(side, A_CORE, 7)
    side.clock.advance(2)
    side.hs.migration.tick()
    step("a acked", sorted(r for r in side.node.state()["records"]))
    report = side.node.gen.reconciler.reconcile_once()
    step("no replay", report["replayed_binds"])
    ack(side, B_CORE, 3)
    side.clock.advance(2)
    side.hs.migration.tick()
    step("b acked", side.hs.drain.tick())


def _replacement(side, step):
    """a's pod goes; its replacement (a new uid) binds on this node."""
    side.exit_pod("a")
    side.hs.migration.tick()
    step("a gone", sorted(side.hs.migration.status()["suppressed_pods"]))
    side.hs.drain.cancel_request()
    step("drain cancelled", side.hs.drain.tick())
    side.admit("a", "2", uid="uid-a2")
    for kind, chip, units in HANDSHAKE_SETS[:2]:
        side.bind(kind, "a", chip, units)
    for _ in range(2):              # first sighting, then a fresh LIST
        side.clock.advance(1)
        side.hs.migration.tick()
    step("restore stamped", restore_env(side, A_CORE))


def resume(variant):
    def script(side, step):
        early_reclaim(side, step)
        _replacement(side, step)
        if variant == "regress":
            ack(side, A_CORE, 5, kind="resume", world_size=1)
        elif variant == "world":
            ack(side, A_CORE, 8, kind="resume", world_size=2)
        if variant != "ok":
            for i in range(2):      # one failure, however many ticks
                side.clock.advance(1)
                side.hs.migration.tick()
                step(f"rejected {i}",
                     side.hs.migration.status()["verify_failures_total"])
        ack(side, A_CORE, 8, kind="resume", world_size=1)
        side.clock.advance(1)
        side.hs.migration.tick()
        step("verified", side.hs.migration.status()["completed_total"])
    script.__name__ = f"resume_{variant}"
    return script


def precopy(chain_dir, manifest):
    def script(side, step):
        side.hs.drain.request_drain()
        step("draining", side.hs.drain.tick())
        for round_ in range(3):     # equal deltas: converged at round 2
            ack(side, A_CORE, 2 * round_ + 1, kind="precopy",
                extra={"round": round_,
                                     "delta_bytes": 4096,
                                     "total_bytes": 4096})
            side.clock.advance(2)
            side.hs.migration.tick()
            step(f"round {round_}", restore_env(side, A_CORE))
        ack(side, A_CORE, 6, checkpoint_dir=chain_dir,
            digest=manifest["chain"],
            extra={"precopy_rounds": 3, "delta_bytes": 4096,
                   "full_bytes": 4096, "cutover_ms": 12.5})
        side.clock.advance(2)
        side.hs.migration.tick()
        step("final delta", side.hs.migration.status()["records"])
        _replacement(side, step)
        ack(side, A_CORE, 7, kind="resume", world_size=1)
        block = f"{chain_dir}/blocks/{manifest['blocks'][0]}.bin"
        with open(block, "rb") as f:
            data = f.read()
        os.unlink(block)
        try:
            side.clock.advance(1)
            side.hs.migration.tick()
            step("torn", side.hs.migration.status()["completed_total"])
        finally:
            with open(block, "wb") as f:
                f.write(data)
        side.clock.advance(1)
        side.hs.migration.tick()
        step("repaired", side.hs.migration.status()["completed_total"])
    return script


def qos(side, step):
    ack(side, A_CORE, 4)
    side.clock.advance(2)
    side.hs.migration.tick()
    step("published", side.hs.migration.publish_record(
        "default/a", reason="qos_evict"))
    step("never acked", side.hs.migration.publish_record("default/b"))


def run(script, port, hashes):
    side = HandshakeSide(port)
    trace = []

    def step(label, value):
        snap = dict(side.hs.snapshot(), objects=objects(side))
        text = json.dumps(to_agent([label, value, snap],
                                   hashes if port else {}))
        trace.append(json.loads(TRACE.sub('"<trace>"', text)))

    try:
        script(side, step)
        return trace
    finally:
        side.close()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A delta chain both sides verify: two rounds of 16-byte blocks."""
    d = str(tmp_path_factory.mktemp("chain"))
    ck = checkpointing.DeltaCheckpointer(d, block_size=16)
    ck.save(5, bytes(range(64)))
    ck.save(6, bytes(range(1, 65)))
    return d, ck.read_manifest(6)


def scripts(chain):
    return {"early_reclaim": early_reclaim, "qos": qos,
            "precopy": precopy(*chain),
            **{f"resume_{v}": resume(v) for v in ("ok", "regress", "world")}}


NAMES = ["early_reclaim", "qos", "precopy", "resume_ok", "resume_regress",
         "resume_world"]


@pytest.mark.parametrize("name", NAMES)
def test_migration_script_matches_the_agents(name, chain):
    hashes = hash_map(HANDSHAKE_SETS)
    script = scripts(chain)[name]
    port, agent = run(script, True, hashes), run(script, False, hashes)
    assert [t[0] for t in port] == [t[0] for t in agent]
    for p, a in zip(port, agent):
        assert p == a, p[0]
    CHECKS[name.split("_")[0]]({t[0]: t[1:] for t in port}, name)


def _early(t, name):
    value, snap = t["a acked"]
    assert value == ["default/b"]                      # a reclaimed early
    mig = snap["migration"]
    assert mig["early_reclaims_total"] == 1
    assert mig["suppressed_pods"] == ["default/a"]
    rec = mig["records"]["default/a"]
    assert (rec["step"], rec["published"], rec["reclaimed"]) == (7, True,
                                                                 True)
    assert rec["reason"] == "drain:operator"
    (obj,) = snap["objects"].values()
    assert obj["status"]["phase"] == "Migrated"
    assert obj["spec"]["migration"]["trace"] == "<trace>"   # a's bind's
    assert obj["metadata"]["name"] == migration.migration_object_name(
        "default", "a")
    assert ("default/a", "TPUMigrationRecorded") in [
        tuple(e) for e in snap["events"]]
    assert snap["samples"][
        "elastic_tpu_drain_early_reclaims_total{}"] == 1
    assert t["no replay"][0] == 0
    value, snap = t["b acked"]
    assert value == "drained"
    assert snap["drain"]["outcome"] == "drained_acked"
    assert snap["drain"]["acked_pods"] == ["default/a", "default/b"]


def _resume(t, name):
    _early(t, name)
    assert t["a gone"][0] == ["default/b"]
    env = t["restore stamped"][0]
    assert env == {EnvRestoreDir: "/ckpt/checkpoint", EnvRestoreStep: "7",
                   EnvRestoreTrace: "<trace>"}
    if name != "resume_ok":
        assert t["rejected 0"][0] == t["rejected 1"][0] == 1
    value, snap = t["verified"]
    # a's record went (b's stays for b's replacement)
    assert value == 1 and list(snap["objects"]) == [
        migration.migration_object_name("default", "b")]
    assert ("default/a", "TPUMigrationCompleted") in [
        tuple(e) for e in snap["events"]]
    done = snap["migration"]["recent_completions"][-1]
    assert (done["step"], done["world_size"], done["trace"]) == (
        8, 1, "<trace>")
    actions = [a["action"] for k, a in snap["timeline"] if k == "migration"]
    assert actions[-1] == "completed" and "restore_stamped" in actions
    assert snap["samples"]["elastic_tpu_migrations_completed_total{}"] == 1


def _precopy(t, name):
    assert t["round 1"][0] == {}
    assert t["round 2"][0][EnvCutover].startswith("converged:3:")
    (rec,) = t["final delta"][0].values()
    assert rec["reclaimed"] and rec["published"]
    assert t["final delta"][1]["migration"]["cutovers_total"] == 1
    (obj,) = t["final delta"][1]["objects"].values()
    pre = obj["spec"]["migration"]["precopy"]
    assert obj["spec"]["migration"]["mode"] == "precopy"
    assert (pre["rounds"], pre["cutover_reason"], pre["cutover_ms"]) == (
        3, "converged", 12.5)
    assert t["torn"][0] == 0
    assert t["torn"][1]["migration"]["verify_failures_total"] == 1
    assert t["repaired"][0] == 1


def _qos(t, name):
    assert t["published"][0] is True
    assert t["never acked"][0] is False
    (obj,) = t["never acked"][1]["objects"].values()
    assert obj["spec"]["migration"]["reason"] == "qos_evict"


CHECKS = {"early": _early, "resume": _resume, "precopy": _precopy,
          "qos": _qos}


# -- the whole handshake through the port's runner ----------------------------

ARGS = "--preset tiny --batch 8 --seq 32 --warmup-steps 2 --total-steps 12"
ALLOC_ENV = ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
             "ELASTIC_TPU_TRACE_ID", "ELASTIC_TPU_RESTORE_DIR",
             "ELASTIC_TPU_RESTORE_STEP", "ELASTIC_TPU_RESTORE_TRACE",
             "ELASTIC_TPU_FLIGHT_RECORDER", "ELASTIC_TPU_HBM_FRACTION")


def _runner(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert trunner.main(argv.split(), device="cpu") == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_runner_handshake_on_the_cpu(tmp_path, monkeypatch):
    for name in ALLOC_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ELASTIC_TPU_ENV_FILE", str(tmp_path / "no-env"))
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_WAIT_S", "0")
    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 2049) ** 1.1
    data = str(tmp_path / "tokens.bin")
    tdata.write_token_file(
        data, rng.permutation(2048)[rng.choice(2048, 30000, p=p / p.sum())])
    base = f"{ARGS} --data {data} --steps 12"
    whole = _runner(base)

    side = HandshakeSide(True, clock=SYSTEM_CLOCK)
    try:
        hs, h = side.hs, side.hash(*A_CORE)
        monkeypatch.setenv("TPU", h)
        monkeypatch.setenv("ELASTIC_TPU_ALLOC_DIR", side.node.alloc_dir)
        # the coordinator ticks as each pre-copy round lands, and the
        # watcher reads the spec at its next step (in place of the
        # agent's loop and the watcher's one-second poll)
        acked = lifecycle.LifecycleWatcher.ack_precopy

        def ack_and_tick(self, *a, **kw):
            out = acked(self, *a, **kw)
            hs.migration.tick()
            self._next_poll = 0.0
            return out

        monkeypatch.setattr(lifecycle.LifecycleWatcher, "ack_precopy",
                            ack_and_tick)
        hs.drain.request_drain("cpu-test")
        assert hs.drain.tick() == "draining"
        ck = str(tmp_path / "ck")
        first = _runner(f"{base} --precopy-every 2 --checkpoint-every 0 "
                        f"--checkpoint-dir {ck}")
        assert first["lifecycle_signal"] == "drain"
        assert 0 < first["steps"] < 12                  # cut over early
        hs.migration.tick()
        status = hs.migration.status()
        assert status["cutovers_total"] == 1 and status[
            "early_reclaims_total"] == 1
        rec = status["records"]["default/a"]
        assert rec["published"] and rec["reclaimed"]
        assert rec["digest"] == migration.verify_delta_chain(ck)["chain"]
        assert "default/a" not in side.node.state()["records"] and \
            hs.drain.tick() == "draining"               # b still bound
        side.exit_pod("b")
        assert hs.drain.tick() == "drained"
        assert hs.drain.status()["acked_pods"] == ["default/a"]

        # the replacement, its restore env stamped by the coordinator
        side.exit_pod("a")
        hs.migration.tick()
        hs.drain.cancel_request()
        assert hs.drain.tick() == "active"
        side.admit("a", "2", uid="uid-a2")
        for kind, chip, units in HANDSHAKE_SETS[:2]:
            side.bind(kind, "a", chip, units)
        for _ in range(2):
            time.sleep(0.001)       # a LIST newer than the first sighting
            hs.migration.tick()
        env = restore_env(side, A_CORE)
        assert env[EnvRestoreDir] == ck and env[EnvRestoreStep] == str(
            rec["step"])
        # the rest of the step budget from the restored step
        second = _runner(f"{ARGS} --data {data} --steps "
                         f"{12 - rec['step'] - 1}")
        assert second["resumed_from_migration"]
        assert second["start_step"] == rec["step"] + 1
        assert second["final_loss"] == whole["final_loss"]
        hs.migration.tick()
        status = hs.migration.status()
        assert status["completed_total"] == 1 and status["inbound"] == {}
        rows = side.node.gen.timeline.events(pod="default/a")
        done = [r for r in rows if r["kind"] == "migration"
                and r["attrs"].get("action") == "completed"]
        assert done and done[-1]["keys"]["trace"] == env[EnvRestoreTrace]
    finally:
        side.close()
