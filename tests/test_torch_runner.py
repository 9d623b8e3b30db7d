"""The PyTorch port's runner (elastic_tpu_agent_torch/workloads/runner.py)
in-process on the CPU: train-mode parity with the JAX runner on the same
data and weights, resume, the lifecycle handshake with pre-copy migration,
decode mode, and the options that belong to later slices.

Tolerance of the parity test: the tiny preset computes in bf16 in both
runners, which round products at different places (XLA's fusions, the
port's plain flash attention against JAX's einsum attention), so each
logit is known to about bf16's 2^-8 relative. A loss is a mean over 256
next-token losses, whose rounding differences mostly cancel. On the
Zipf-distributed file the sound runs agree to 1.4e-6 (final loss) and
1.1e-4 (eval losses). Loop faults planted in the port's runner, run the
same way, moved them by 0.049 or more: the schedule read one count late
0.148 (final) and 0.386, 0.049 (evals); one update skipped 0.241 and 0.655,
0.200; eval on the training region 0.182, 0.116 (evals). The limit, 2e-3,
sits between.
"""

import contextlib
import io
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from elastic_tpu_agent.workloads import checkpointing as jck  # noqa: E402
from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import runner as jrunner  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import data as tdata  # noqa: E402
from elastic_tpu_agent_torch.workloads import runner as trunner  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

LOSS_TOL = 2e-3
ARGS = "--preset tiny --batch 8 --seq 32"
ALLOC_ENV = (
    "TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR", "TPU_WORKER_HOSTNAMES",
    "ELASTIC_TPU_HBM_FRACTION", "TPU_MEM_FRACTION", "ELASTIC_TPU_TRACE_ID",
    "ELASTIC_TPU_FLIGHT_RECORDER", "ELASTIC_TPU_RESTORE_DIR",
    "ELASTIC_TPU_RESTORE_STEP", "ELASTIC_TPU_RESTORE_TRACE",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch, tmp_path):
    """No alloc env leaks in from the host or between runs; the env file
    path points at nothing."""
    for name in ALLOC_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ELASTIC_TPU_ENV_FILE", str(tmp_path / "no-env"))
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_WAIT_S", "0")


def _run(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv.split(), **kw) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port(argv):
    return _run(trunner.main, argv, device="cpu")


@pytest.fixture
def data_file(tmp_path):
    """30,000 tokens with a Zipf(1.1) unigram law over a random
    permutation of the tiny vocabulary: text-like frequencies, so that
    the loss falls within a few steps and a loop fault shows in it."""
    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 2049) ** 1.1
    path = str(tmp_path / "tokens.bin")
    tdata.write_token_file(
        path, rng.permutation(2048)[rng.choice(2048, 30000, p=p / p.sum())])
    return path


def test_train_matches_the_jax_runner(data_file, monkeypatch):
    """Same file, same initial weights (the JAX runner's init_all(key(0))
    bridged in through a test-only patch of the port's init): the final
    and eval losses agree within LOSS_TOL, and the reports carry the same
    keys."""
    argv = (f"{ARGS} --steps 4 --warmup-steps 2 --eval-every 2 "
            f"--data {data_file}")
    want = _run(jrunner.main, argv)
    jcfg = jt.ModelConfig(max_seq=32, **jrunner.PRESETS["tiny"])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    real = tt.make_train_step

    def from_jax(cfg, **kw):
        step, _, opt = real(cfg, **kw)

        def init_all(generator):
            params = params_from_jax(tree, cfg, device="cpu",
                                     dtype=torch.float32)
            return params, opt.init(params)

        return step, init_all, opt

    monkeypatch.setattr(tt, "make_train_step", from_jax)
    got = _port(argv)
    assert set(got) == set(want)
    assert set(got["flight_recorder"]) == set(want["flight_recorder"])
    assert got["flight_recorder"]["jit_recompiles"] is None
    assert (got["steps"], got["start_step"]) == (want["steps"],
                                                 want["start_step"]) == (4, 0)
    assert got["lr_schedule"] == want["lr_schedule"]
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_TOL
    assert [e["step"] for e in got["eval"]] == [1, 3]
    for g, w in zip(got["eval"], want["eval"]):
        assert g["step"] == w["step"]
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL


def test_resume_from_checkpoint_dir(tmp_path, data_file):
    """Two runs on one --checkpoint-dir: the second resumes where the
    first stopped (saves at steps 1 and 3), and its flight recorder file
    holds a record per step."""
    ck = str(tmp_path / "ck")
    argv = (f"{ARGS} --steps 4 --checkpoint-dir {ck} --checkpoint-every 2 "
            f"--data {data_file} --warmup-steps 2 --total-steps 8")
    first = _port(f"{argv} --flight-recorder {tmp_path / 'fr.jsonl'}")
    assert first["start_step"] == 0 and first["steps"] == 4
    assert sorted(os.listdir(ck)) == ["1", "3"]
    steps = [r for r in ttel.load_jsonl(str(tmp_path / "fr.jsonl"))
             if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    second = _port(argv)
    assert second["start_step"] == 4 and second["steps"] == 4
    assert np.isfinite(second["final_loss"])
    assert sorted(os.listdir(ck)) == ["3", "5", "7"]


def _alloc(tmp_path, monkeypatch, env):
    alloc = tmp_path / "alloc"
    alloc.mkdir(exist_ok=True)
    (alloc / "h1.json").write_text(json.dumps({"env": env}))
    monkeypatch.setenv("TPU", "h1")
    monkeypatch.setenv("ELASTIC_TPU_ALLOC_DIR", str(alloc))
    return str(alloc)


def test_precopy_drain_acks_a_verified_chain_and_resumes(tmp_path,
                                                         monkeypatch):
    """A drain stamped before the run: training goes on while deltas
    stream (rounds at steps 4 and 9), the step budget ends mid-stream and
    a final delta closes it; the ack's digest is the chain JAX's verify()
    accepts, and the next run resumes from the chain."""
    alloc = _alloc(tmp_path, monkeypatch, {
        "ELASTIC_TPU_DRAIN": "maintenance:X",
        "ELASTIC_TPU_DRAIN_DEADLINE": str(time.time() + 3600),
    })
    ck = str(tmp_path / "ck")
    report = _port(f"{ARGS} --steps 10 --precopy-every 5 "
                   f"--checkpoint-every 0 --checkpoint-dir {ck}")
    assert report["precopy_rounds"] == 2 and report["steps"] == 10
    assert report["lifecycle_signal"] == "drain"
    ack = jlc.read_checkpoint_ack(alloc, "h1")
    assert ack["kind"] == "checkpoint" and ack["step"] == 9
    assert ack["precopy_rounds"] == 2 and ack["cutover_ms"] >= 0
    assert 0 <= ack["delta_bytes"] <= ack["full_bytes"]
    verified = jck.DeltaCheckpointer(ck).verify()
    assert verified["ok"] and verified["chain"] == ack["digest"]
    assert verified["step"] == 9
    assert not [n for n in os.listdir(ck) if n.isdigit()]  # deltas only

    # a replacement pod with only the restore stamp resumes from the chain
    _alloc(tmp_path, monkeypatch, {
        "ELASTIC_TPU_RESTORE_DIR": ck, "ELASTIC_TPU_RESTORE_STEP": "9",
    })
    resumed = _port(f"{ARGS} --steps 2 --checkpoint-every 0")
    assert resumed["start_step"] == 10 and resumed["resumed_from_migration"]
    ack = jlc.read_checkpoint_ack(alloc, "h1")
    assert ack["kind"] == "resume" and ack["step"] == 9
    assert ack["world_size"] == 1


def test_deadline_cutover_and_classic_drain(tmp_path, monkeypatch):
    """A drain whose deadline's last quarter has come cuts over at once
    (the workload-side safety net: a final delta at step 0, one pause);
    with --precopy-every 0 a drain is checkpoint-and-exit with a full
    save, acked with the directory digest."""
    alloc = _alloc(tmp_path, monkeypatch, {
        "ELASTIC_TPU_DRAIN": "preemption",
        "ELASTIC_TPU_DRAIN_DEADLINE": str(time.time() - 1),
    })
    ck = str(tmp_path / "ck")
    report = _port(f"{ARGS} --steps 6 --checkpoint-dir {ck}")
    assert report["preempted"] and report["steps"] == 1
    assert report["precopy_rounds"] == 0
    ack = jlc.read_checkpoint_ack(alloc, "h1")
    assert ack["step"] == 0 and ack["precopy_rounds"] == 0
    assert ack["delta_bytes"] == ack["full_bytes"] > 0
    assert jck.DeltaCheckpointer(ck).verify()["chain"] == ack["digest"]

    ck2 = str(tmp_path / "ck2")
    report = _port(f"{ARGS} --steps 6 --precopy-every 0 "
                   f"--checkpoint-dir {ck2}")
    assert report["preempted"] and report["steps"] == 1
    ack = jlc.read_checkpoint_ack(alloc, "h1")
    assert ack["kind"] == "checkpoint" and ack["step"] == 0
    assert ack["digest"] == jlc.checkpoint_digest(ck2)
    assert sorted(os.listdir(ck2)) == ["0"]


def test_decode_mode_restores_the_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    _port(f"{ARGS} --steps 3 --checkpoint-dir {ck} --checkpoint-every 3")
    report = _port(f"--mode decode {ARGS} --prompt-len 8 --new-tokens 6 "
                   f"--checkpoint-dir {ck}")
    assert report["restored_step"] == 2 and report["mode"] == "decode"
    assert report["platform"] == "cpu" and len(report["sample_tail"]) == 5
    fresh = _port(f"--mode decode {ARGS} --prompt-len 8 --new-tokens 6")
    assert fresh["restored_step"] is None
    assert set(fresh) == set(report)
    with pytest.raises(SystemExit):
        _port(f"--mode decode {ARGS} --checkpoint-dir {tmp_path / 'none'}")


def test_decode_int8_matches_the_jax_runner(monkeypatch):
    """--mode decode --int8 in both runners on the same weights (the JAX
    runner's init_params(key(0)), bridged in f32 through a test-only patch
    of the port's init) and the same prompts (the JAX runner's, through a
    patch of decode_prompt): the reports carry the same keys, int8 true,
    and the same greedy sample_tail. Both compute in bf16 from the same
    int8 tree; the five tokens must agree exactly."""
    argv = f"--mode decode {ARGS} --prompt-len 8 --new-tokens 6 --int8"
    want = _run(jrunner.main, argv)
    jcfg = jt.ModelConfig(max_seq=32, **jrunner.PRESETS["tiny"])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    prompt = np.array(jax.random.randint(
        jax.random.key(1), (8, 8), 0, jcfg.vocab))
    monkeypatch.setattr(
        tt, "init_params", lambda cfg, generator, device, dtype=None:
        params_from_jax(tree, cfg, device=device, dtype=dtype))
    monkeypatch.setattr(trunner, "decode_prompt", lambda cfg, b, p: prompt)
    got = _port(argv)
    assert set(got) == set(want)
    assert got["int8"] is want["int8"] is True
    assert got["sample_tail"] == want["sample_tail"]
    plain = _port(argv.replace(" --int8", ""))
    assert plain["int8"] is False and set(plain) == set(got)


@pytest.mark.parametrize("argv,exc,match", [
    ("--mode decode --params-dir /x", NotImplementedError, "export"),
])
def test_later_slices_raise(argv, exc, match):
    with pytest.raises(exc, match=match):
        _port(f"{ARGS} {argv}")


@pytest.mark.parametrize("argv", ["--dp 2", "--tp 2", "--sp 2", "--pp 2",
                                  "--zero1"])
def test_multi_gpu_flags_are_usage_errors(argv, capsys):
    with pytest.raises(SystemExit):
        _port(f"{ARGS} {argv}")
    assert "multi-GPU slice" in capsys.readouterr().err


def test_single_card_guards(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a,b")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        _port(f"{ARGS} --steps 1")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "a")
    trunner.maybe_join_slice()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trunner.main(f"{ARGS} --steps 1".split())


def test_apply_hbm_quota_sets_the_fraction_only_on_a_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda frac, device=None: calls.append(
                            (frac, device)))
    trunner.apply_hbm_quota("cpu")           # no quota: nothing at all
    assert calls == [] and "TPU_MEM_FRACTION" not in os.environ
    monkeypatch.setenv("ELASTIC_TPU_HBM_FRACTION", "0.25")
    trunner.apply_hbm_quota("cpu")
    assert calls == [] and os.environ["TPU_MEM_FRACTION"] == "0.25"
    trunner.apply_hbm_quota(torch.device("cuda", 0))
    assert calls == [(0.25, torch.device("cuda", 0))]


def test_env_file_applied_and_profile_written(tmp_path, monkeypatch):
    env_file = tmp_path / "env"
    env_file.write_text("ELASTIC_TPU_TRACE_ID=trace-9\nnot a pair\n")
    monkeypatch.setenv("ELASTIC_TPU_ENV_FILE", str(env_file))
    report = _port(f"{ARGS} --steps 2 --profile-dir {tmp_path / 'prof'}")
    assert report["alloc_env"] == {"ELASTIC_TPU_TRACE_ID": "trace-9"}
    assert report["flight_recorder"]["trace_id"] == "trace-9"
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
