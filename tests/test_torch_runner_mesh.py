"""The port's runner across ranks (``runner.py``: the slice join, the mesh
flags, gathered checkpoints) against the JAX runner, on the CPU.

The JAX runner runs in ONE subprocess with 4 host devices
(``--xla_force_host_platform_device_count=4``: this process's 8 would
not fit a 2 x 2 mesh), every leg in sequence. The port's runs in one
spawned world of 4 processes (``torch_worlds.py`` ``runner_legs``) that
join through the runner's own ``maybe_join_slice``: first as one host of
4 ranks (``LOCAL_RANK``/``LOCAL_WORLD_SIZE``), then ranks 0 and 1 as the
two-host agent-env slice of ``tests/test_multiproc_slice.py``
(``TPU_WORKER_HOSTNAMES=localhost,localhost``, ``TPU_WORKER_ID``).

Both runners read one Zipf token file (``--data``), tiny preset, batch 8,
seq 32, 3 steps, computing in f32 (a test-only patch of the presets on
both sides), from the same weights (the JAX runner's init trees, bridged
into the port's ``init_all`` by a test-only patch). The losses then differ
only by f32 summation order across the collectives: LOSS_TOL 1e-5. Decode
tails are greedy and exact.

The lifecycle legs run the port alone: ZeRO-1 checkpoints and pre-copy
delta chains written at world 4 and resumed at world 2, drains and
cutovers stamped in an alloc dir, and a SIGTERM that lands on one rank
inside a pre-copy round. Every rank must stop at the same step, and the
chains and acks must be what the JAX package's verifier accepts.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import checkpointing as jck  # noqa: E402
from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import runner as jrunner  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent.workloads import (  # noqa: E402
    transformer_pipeline as jtp,
)
from elastic_tpu_agent_torch.workloads import data as tdata  # noqa: E402

import torch_worlds  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
WORLD = 4
ARGS = "--preset tiny --batch 8 --seq 32 --steps 3"
DECODE = "--mode decode --preset tiny --batch 8 --seq 32 --prompt-len 8 " \
         "--new-tokens 6 --dp 2 --tp 2"
# the two-host slice's legs: a host's --batch 4 shard, world 2
SLICE = "--batch 4 --dp 2 --tp 1"
ZERO1 = "--dp 2 --tp 2 --zero1 --master-weights"
PIPE = "--pp 2 --pp-schedule 1f1b --n-micro 4"
# a pre-copy stream: rounds at steps 1 and 3, and the step budget closes
# it with a final delta at step 4
PRECOPY = "--steps 5 --precopy-every 2 --checkpoint-every 0"
# legs run by both runners on 4 devices / ranks
SHARED = {
    "dp2tp2": "--dp 2 --tp 2",
    "sp2": "--sp 2",
    "zero1": ZERO1,
    "pp2_1f1b": PIPE,
}

JAX_SCRIPT = r"""
import contextlib, io, json, sys
import jax.numpy as jnp
from elastic_tpu_agent.workloads import runner
for name in runner.PRESETS:
    runner.PRESETS[name] = dict(runner.PRESETS[name], dtype=jnp.float32)
out = {}
for name, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert runner.main(argv.split()) == 0
    out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
print(json.dumps(out))
"""


def _alloc(d, name, drain, deadline):
    """An alloc dir whose pod ``h1`` carries a drain stamp; the env that
    points a runner at it."""
    alloc = d / name
    alloc.mkdir()
    (alloc / "h1.json").write_text(json.dumps({"env": {
        "ELASTIC_TPU_DRAIN": drain,
        "ELASTIC_TPU_DRAIN_DEADLINE": str(deadline)}}))
    return {"env": {"TPU": "h1", "ELASTIC_TPU_ALLOC_DIR": str(alloc)}}


def _zipf_file(path):
    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 2049) ** 1.1
    tdata.write_token_file(
        path, rng.permutation(2048)[rng.choice(2048, 30000, p=p / p.sum())])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX reports, the port's reports of every rank), both runners
    started together."""
    d = tmp_path_factory.mktemp("runner_mesh")
    data = str(d / "tokens.bin")
    _zipf_file(data)
    ck, ckz, ckd, ckp = (str(d / n) for n in ("ck", "ckz", "ckd", "ckp"))
    far = time.time() + 3600
    shared = [(name, f"{ARGS} --data {data} {argv}")
              for name, argv in SHARED.items()]
    env = {k: v for k, v in os.environ.items()
           if k not in torch_worlds.RUNNER_ENV + ("TPU_WORKER_HOSTNAMES",
                                                  "TPU_WORKER_ID")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               ELASTIC_TPU_ENV_FILE=str(d / "no-env-file"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT,
         json.dumps(shared + [("decode", DECODE)])],
        cwd=str(d), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        cfg = jt.ModelConfig(max_seq=32, dtype=jnp.float32,
                             **jrunner.PRESETS["tiny"])
        spec = dict(
            dir=str(d),
            tree=jax.device_get(jt.init_params(cfg, jax.random.key(0))),
            pipe_tree=jax.device_get(jtp.init_pipeline_params(
                cfg, jax.random.key(0), 2)),
            prompt=np.asarray(jax.random.randint(
                jax.random.key(1), (8, 8), 0, cfg.vocab)),
            legs=shared + [
                ("decode", DECODE),
                ("saved", f"{ARGS} --data {data} --dp 2 --tp 2 "
                          f"--checkpoint-dir {ck} --checkpoint-every 3"),
                ("uninterrupted", f"{ARGS} --data {data} --dp 2 --tp 2 "
                                  "--steps 6"),
                ("zero1_saved", f"{ARGS} --data {data} {ZERO1} "
                                f"--checkpoint-dir {ckz} --checkpoint-every 3"),
                ("zero1_uninterrupted", f"{ARGS} --data {data} {ZERO1} "
                                        "--steps 6"),
                ("pp_saved", f"{ARGS} --data {data} {PIPE} "
                             f"--checkpoint-dir {ckp} --checkpoint-every 3"),
                ("pp_uninterrupted", f"{ARGS} --data {data} {PIPE} "
                                     "--steps 6"),
                ("zero1_precopy", f"{ARGS} --data {data} {ZERO1} {PRECOPY} "
                                  f"--checkpoint-dir {ckd}",
                 _alloc(d, "alloc_precopy", "maintenance:X", far)),
                # the deadline's last quarter has come: cut over at once
                ("cutover", f"{ARGS} --data {data} --dp 2 --tp 2 --steps 6 "
                            f"--checkpoint-dir {d / 'ckc'}",
                 _alloc(d, "alloc_cutover", "preemption", time.time() - 1)),
                ("classic_drain", f"{ARGS} --data {data} --dp 2 --tp 2 "
                                  "--steps 6 --precopy-every 0 "
                                  f"--checkpoint-dir {d / 'ckx'}",
                 _alloc(d, "alloc_classic", "maintenance:Y", far)),
            ],
            # the two-host slice: --batch 4 a host, the same global batch
            slice_legs=[
                ("slice_plain", f"{ARGS} --data {data} {SLICE}"),
                ("slice_zero1", f"{ARGS} --data {data} {SLICE} --zero1 "
                                "--master-weights"),
                ("slice_resume", f"{ARGS} --data {data} {SLICE} "
                                 f"--checkpoint-dir {ck}"),
                ("slice_zero1_resume", f"{ARGS} --data {data} {SLICE} "
                                       "--zero1 --master-weights "
                                       f"--checkpoint-dir {ckz}"),
                ("slice_pp_resume", f"{ARGS} --data {data} --batch 4 "
                                    f"{PIPE} --checkpoint-dir {ckp}"),
                ("slice_delta_resume", f"{ARGS} --data {data} {SLICE} "
                                       "--zero1 --master-weights --steps 1 "
                                       f"--checkpoint-dir {ckd}"),
                # rank 1 is sent SIGTERM inside the round at step 1
                ("slice_sigterm", f"{ARGS} --data {data} {SLICE} {PRECOPY} "
                                  f"--checkpoint-dir {d / 'cks'}",
                 dict(_alloc(d, "alloc_sigterm", "maintenance:Z", far),
                      sigterm_rank=1)),
            ],
        )
        port = torch_worlds.run_world(torch_worlds.runner_legs, WORLD, spec,
                                      init=False)
        out, err = jax_proc.communicate(timeout=torch_worlds.WORLD_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), port, d


def _agreed(port, name, ranks=range(WORLD)):
    """A leg's report: the loss and shapes every rank shares; rank 0
    alone prints it."""
    reps = [port[r][name] for r in ranks]
    for r, rep in zip(ranks, reps):
        assert rep["root"] is (r == 0)
        for key in ("final_loss", "steps", "start_step", "devices", "mesh",
                    "sample_tail", "preempted", "precopy_rounds",
                    "lifecycle_signal"):
            assert rep.get(key) == reps[0].get(key), (name, r, key)
    return reps[0]


@pytest.mark.parametrize("leg", sorted(SHARED))
def test_mesh_losses_match_the_jax_runner(runs, leg):
    """--dp 2 --tp 2, --sp 2, --zero1 --master-weights and --pp 2 1F1B:
    the final loss within LOSS_TOL of the JAX runner's on 4 devices, with
    the same report keys, device count and mesh."""
    want, port, _ = runs
    got = _agreed(port, leg)
    assert set(got) - {"root"} == set(want[leg])
    assert got["devices"] == want[leg]["devices"] == WORLD
    assert got["mesh"] == want[leg]["mesh"]
    assert got["steps"] == want[leg]["steps"] == 3
    assert abs(got["final_loss"] - want[leg]["final_loss"]) <= LOSS_TOL


def test_decode_tails_match_the_jax_runner(runs):
    want, port, _ = runs
    got = _agreed(port, "decode")
    assert got["mesh"] == want["decode"]["mesh"] == {
        "dp": 2, "sp": 1, "tp": 2, "ep": 1}
    assert got["sample_tail"] == want["decode"]["sample_tail"]
    assert set(got) - {"root"} == set(want["decode"])


def test_resume_at_a_changed_world_size_continues_the_loss(runs):
    """A world-4 run (dp 2 x tp 2) saves the whole trees at step 2; the
    two-host slice (dp 2, world 2) resumes from them at step 3 and ends
    where an uninterrupted world-4 run of 6 steps ends."""
    _, port, _ = runs
    saved = _agreed(port, "saved")
    resumed = _agreed(port, "slice_resume", ranks=(0, 1))
    whole = _agreed(port, "uninterrupted")
    assert (saved["start_step"], resumed["start_step"]) == (0, 3)
    assert resumed["devices"] == 2 and resumed["mesh"]["tp"] == 1
    assert abs(resumed["final_loss"] - whole["final_loss"]) <= LOSS_TOL


@pytest.mark.parametrize("leg,world4", [("slice_plain", "dp2tp2"),
                                        ("slice_zero1", "zero1")])
def test_two_process_agent_env_slice_agrees(runs, leg, world4):
    """Two hosts of one rank each, joined from the agent's slice env: both
    ranks report the same loss, plain and with --zero1 --master-weights,
    and each host's --batch 4 shard makes the one-host run's global batch
    of 8 (the loss within LOSS_TOL of the world-4 run's)."""
    _, port, _ = runs
    got = _agreed(port, leg, ranks=(0, 1))
    assert got["devices"] == 2 and got["mesh"] == {
        "dp": 2, "sp": 1, "tp": 1, "ep": 1}
    assert abs(got["final_loss"] - _agreed(port, world4)["final_loss"]) <= (
        LOSS_TOL)


def test_slice_layout_from_the_agent_env():
    """rank = TPU_WORKER_ID x LOCAL_WORLD_SIZE + LOCAL_RANK, the
    coordinator the first host at ELASTIC_TPU_COORD_PORT (8476)."""
    from elastic_tpu_agent_torch.workloads import runner as trunner

    lay = trunner.slice_layout({
        "TPU_WORKER_HOSTNAMES": "h0,h1,h2", "TPU_WORKER_ID": "2",
        "LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"})
    assert (lay.rank, lay.world, lay.local_rank) == (11, 12, 3)
    assert lay.coordinator == "tcp://h0:8476"
    one = trunner.slice_layout({})
    assert (one.rank, one.world, one.hosts) == (0, 1, ("localhost",))
    for bad in ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "2"},
                {"LOCAL_RANK": "1"}):
        with pytest.raises(ValueError):
            trunner.slice_layout(bad)


def test_zero1_checkpoint_resumes_at_a_changed_world_size(runs):
    """A world-4 --zero1 --master-weights run saves its whole trees (the
    optimizer state gathered over dp and the split specs) at step 2; the
    two-host slice (dp 2, world 2, the state cut over its own dp) resumes
    at step 3 and ends where an uninterrupted world-4 run of 6 steps
    ends."""
    _, port, _ = runs
    saved = _agreed(port, "zero1_saved")
    resumed = _agreed(port, "slice_zero1_resume", ranks=(0, 1))
    whole = _agreed(port, "zero1_uninterrupted")
    assert (saved["start_step"], resumed["start_step"]) == (0, 3)
    assert resumed["devices"] == 2 and whole["devices"] == WORLD
    assert abs(resumed["final_loss"] - whole["final_loss"]) <= LOSS_TOL


def test_pipeline_checkpoint_resumes_at_a_changed_world_size(runs):
    """A world-4 1F1B run (pp 2 x dp 2) saves the stacked stages whole at
    step 2; the two-host slice (pp 2 x dp 1) resumes at step 3 and ends
    where an uninterrupted world-4 run of 6 steps ends."""
    _, port, _ = runs
    saved = _agreed(port, "pp_saved")
    resumed = _agreed(port, "slice_pp_resume", ranks=(0, 1))
    whole = _agreed(port, "pp_uninterrupted")
    assert (saved["start_step"], resumed["start_step"]) == (0, 3)
    assert resumed["mesh"] == {"pp": 2, "dp": 1}
    assert whole["mesh"] == {"pp": 2, "dp": 2}
    assert abs(resumed["final_loss"] - whole["final_loss"]) <= LOSS_TOL


def test_precopy_chain_from_every_rank_verifies_and_resumes(runs):
    """A drain stamped before a world-4 ZeRO-1 run: every rank streams the
    same rounds (steps 1 and 3) and the step budget closes the stream at
    step 4; rank 0's ack carries the digest of the chain the JAX package
    verifies, and the two-host slice resumes from the chain at step 5 on
    the uninterrupted run's loss."""
    _, port, d = runs
    got = _agreed(port, "zero1_precopy")
    assert (got["steps"], got["precopy_rounds"]) == (5, 2)
    assert got["lifecycle_signal"] == "drain" and not got["preempted"]
    ack = jlc.read_checkpoint_ack(str(d / "alloc_precopy"), "h1")
    assert ack["kind"] == "checkpoint" and ack["step"] == 4
    assert ack["precopy_rounds"] == 2
    verified = jck.DeltaCheckpointer(str(d / "ckd")).verify()
    assert verified["ok"] and verified["step"] == 4
    assert verified["chain"] == ack["digest"]
    resumed = _agreed(port, "slice_delta_resume", ranks=(0, 1))
    assert resumed["start_step"] == 5
    whole = _agreed(port, "zero1_uninterrupted")
    assert abs(resumed["final_loss"] - whole["final_loss"]) <= LOSS_TOL


def test_cutover_and_classic_drain_stop_every_rank_at_once(runs):
    """Rank 0's signal is every rank's: a drain whose deadline's last
    quarter has come cuts over at step 0 with a final delta, and a drain
    with --precopy-every 0 checkpoints and exits at step 0, on all four
    ranks."""
    _, port, d = runs
    for leg, alloc in (("cutover", "alloc_cutover"),
                       ("classic_drain", "alloc_classic")):
        got = _agreed(port, leg)
        assert got["preempted"] and got["steps"] == 1, leg
        assert got["precopy_rounds"] == 0, leg
        ack = jlc.read_checkpoint_ack(str(d / alloc), "h1")
        assert ack["kind"] == "checkpoint" and ack["step"] == 0, leg
    cut = jlc.read_checkpoint_ack(str(d / "alloc_cutover"), "h1")
    assert jck.DeltaCheckpointer(str(d / "ckc")).verify()["chain"] == (
        cut["digest"])
    classic = jlc.read_checkpoint_ack(str(d / "alloc_classic"), "h1")
    assert classic["digest"] == jlc.checkpoint_digest(str(d / "ckx"))
    assert sorted(os.listdir(d / "ckx")) == ["0"]


def test_sigterm_on_one_rank_stops_both_at_the_same_step(runs):
    """SIGTERM reaches rank 1 alone, inside the pre-copy round at step 1.
    The stop is agreed at the next poll: both ranks run step 2, save the
    whole trees there together and leave, and the stream's final delta
    closes the chain at the same step."""
    _, port, d = runs
    got = _agreed(port, "slice_sigterm", ranks=(0, 1))
    assert got["preempted"] and got["steps"] == 3
    assert got["precopy_rounds"] == 1
    ck = d / "cks"
    assert [n for n in os.listdir(ck) if n.isdigit()] == ["2"]
    ack = jlc.read_checkpoint_ack(str(d / "alloc_sigterm"), "h1")
    assert ack["step"] == 2
    assert jck.DeltaCheckpointer(str(ck)).verify()["chain"] == ack["digest"]
