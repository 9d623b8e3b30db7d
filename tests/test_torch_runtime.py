"""The PyTorch port's in-pod runtime (elastic_tpu_agent_torch/workloads/
contract, data, checkpointing, lifecycle, telemetry and the runner's
schedule) against the JAX package on the same inputs, on the CPU.

Tolerances:
- data, delta chains, tree bytes, acks, digests and sidecar files: exact
  (byte-identical files, equal manifests, equal arrays).
- the warmup-cosine schedule: 2 float32 ulps of optax's value. Both follow
  optax's float32 order of operations, but optax takes XLA's float32
  cosine, which is not correctly rounded, where the port rounds the exact
  cosine of the same float32 argument: an ulp apart at some counts, and
  the products after it may round the other way once more.
- six train steps on the schedule, float32: the bounds of
  tests/test_torch_train.py (losses 1e-5 relative; params 1e-5 absolute
  but for Adam's sign-of-noise elements, at most 1e-4 of them, each within
  2 * lr * steps + 1e-5).
- checkpoint resume on the CPU: bit for bit.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from elastic_tpu_agent import common  # noqa: E402
from elastic_tpu_agent.workloads import checkpointing as jck  # noqa: E402
from elastic_tpu_agent.workloads import data as jdata  # noqa: E402
from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import serving as jserving  # noqa: E402
from elastic_tpu_agent.workloads import telemetry as jtel  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    checkpointing as tck,
)
from elastic_tpu_agent_torch.workloads import contract  # noqa: E402
from elastic_tpu_agent_torch.workloads import data as tdata  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle as tlc  # noqa: E402
from elastic_tpu_agent_torch.workloads import runner as trunner  # noqa: E402
from elastic_tpu_agent_torch.workloads import serving as tserving  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
            max_seq=32)


def _read(path):
    return path.read_bytes()


def _models(dtype=jnp.float32, **kw):
    jcfg = jt.ModelConfig(**TINY, dtype=dtype, attn="reference", **kw)
    tcfg = tt.ModelConfig(
        **TINY, dtype=torch.float32 if dtype == jnp.float32
        else torch.bfloat16, **kw)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree


# -- contract -----------------------------------------------------------------

CONTRACT = [
    "EnvSliceEpoch", "EnvDrain", "EnvDrainDeadline", "EnvThrottle",
    "EnvThrottleDeadline", "UsageReportSubdir", "AckSubdir",
    "FlightSummarySubdir", "EnvRestoreDir", "EnvRestoreStep",
    "EnvRestoreTrace", "EnvCutover", "EnvAllocationHash",
    "EnvAllocationHashCompat",
]


def test_contract_is_pinned_to_common():
    names = sorted(n for n in vars(contract) if not n.startswith("_"))
    assert names == sorted(CONTRACT)
    for name in CONTRACT:
        assert getattr(contract, name) == getattr(common, name), name
    assert tlc.ENV_ALLOC_DIR == jlc.ENV_ALLOC_DIR
    assert ttel.ENV_TRACE_ID == jtel.ENV_TRACE_ID
    assert ttel.ENV_RECORDER_PATH == jtel.ENV_RECORDER_PATH
    assert trunner.ENV_FILE == "/run/elastic-tpu/env"
    from elastic_tpu_agent.workloads import runner as jrunner

    assert trunner.PRESETS == jrunner.PRESETS


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "tokens",
    [np.arange(1000) % 50000, np.array([0, 70000, 123456] * 40), np.arange(0)],
    ids=["uint16", "uint32", "empty"],
)
def test_token_files_are_byte_identical(tmp_path, tokens):
    tdata.write_token_file(str(tmp_path / "t.bin"), tokens)
    jdata.write_token_file(str(tmp_path / "j.bin"), tokens)
    assert _read(tmp_path / "t.bin") == _read(tmp_path / "j.bin")
    ds = tdata.TokenDataset(str(tmp_path / "j.bin"))
    assert ds.n_tokens == tokens.size
    np.testing.assert_array_equal(ds._tokens, tokens)
    assert ds.max_token() == jdata.TokenDataset(
        str(tmp_path / "t.bin")).max_token()


def test_bad_files_rejected(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOPE" + b"\x00" * 32)
    with pytest.raises(ValueError, match="not an ETPU"):
        tdata.TokenDataset(str(p))
    with pytest.raises(ValueError, match="non-negative"):
        tdata.write_token_file(str(p), np.array([-1]))
    tdata.write_token_file(str(tmp_path / "s.bin"), np.arange(10))
    with pytest.raises(ValueError, match="need"):
        tdata.TokenDataset(str(tmp_path / "s.bin")).batch(0, 1, 32)
    tdata.write_token_file(str(tmp_path / "w.bin"), np.arange(15))
    with pytest.raises(ValueError, match="held-out split"):
        tdata.TokenDataset(str(tmp_path / "w.bin")).split_regions(10, 0.1)


@pytest.mark.parametrize("dtype_max", [251, 70000], ids=["uint16", "uint32"])
def test_batches_match_jax(tmp_path, dtype_max):
    """Every batch the JAX pipeline gives (steps past an epoch, dp ranks,
    train/eval regions) comes out of the port equal, and max_token and
    split_regions agree."""
    path = str(tmp_path / "t.bin")
    tdata.write_token_file(path, np.arange(10000) % dtype_max)
    td, jd = tdata.TokenDataset(path), jdata.TokenDataset(path)
    assert td.max_token() == jd.max_token()
    assert td.max_token(sample=100) == jd.max_token(sample=100)
    assert td.sequences_per_epoch(16) == jd.sequences_per_epoch(16)
    for frac in (0.0, 0.1, 0.5):
        assert td.split_regions(16, frac) == jd.split_regions(16, frac)
    train, held = td.split_regions(16, 0.2)
    for step in (0, 3, 700):
        for rank, size in ((0, 1), (0, 2), (1, 2), (2, 3)):
            for region in (None, train, held):
                got = td.batch(step, 4, 16, rank, size, region=region)
                want = jd.batch(step, 4, 16, rank, size, region=region)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    it_t, it_j = td.batches(4, 16, 1, 2, start_step=5), jd.batches(
        4, 16, 1, 2, start_step=5)
    for _ in range(3):
        np.testing.assert_array_equal(next(it_t), next(it_j))


def test_batch_semantics(tmp_path):
    """test_data.py's properties on the port: a pure function of step,
    disjoint shards, global sample identity, one-token overlap, epoch
    wrap, regions respected."""
    path = str(tmp_path / "t.bin")
    tdata.write_token_file(path, np.arange(10000) % 251)
    ds = tdata.TokenDataset(path)
    b0 = ds.batch(step=3, batch=4, seq=16, dp_rank=0, dp_size=2)
    np.testing.assert_array_equal(
        b0, ds.batch(step=3, batch=4, seq=16, dp_rank=0, dp_size=2))
    b1 = ds.batch(step=3, batch=4, seq=16, dp_rank=1, dp_size=2)
    assert not np.array_equal(b0, b1)
    flat = ds.batch(step=0, batch=32, seq=16)
    np.testing.assert_array_equal(b1[0], flat[3 * 8 + 4])
    two = ds.batch(0, 2, 16)
    assert two.shape == (2, 17) and two[0][16] == two[1][0]
    np.testing.assert_array_equal(
        ds.batch(ds.sequences_per_epoch(16), 1, 16), ds.batch(0, 1, 16))
    path = str(tmp_path / "pos.bin")
    tdata.write_token_file(path, np.arange(0, 1000))
    ds = tdata.TokenDataset(path)
    (t0, tn), (e0, en) = ds.split_regions(10, eval_frac=0.2)
    for step in range(3 * ds.sequences_per_epoch(10)):
        idx = ds.batch(step, 4, 10, region=(t0, tn))[:, 0] // 10
        assert (idx < tn).all()
    assert (ds.batch(0, 4, 10, region=(e0, en))[:, 0] // 10 >= e0).all()


def test_encode_file_and_cli(tmp_path):
    src = tmp_path / "text.txt"
    src.write_text("hello gpu")
    assert tdata.encode_file(str(src), str(tmp_path / "t.bin")) == 9
    jdata.encode_file(str(src), str(tmp_path / "j.bin"))
    assert _read(tmp_path / "t.bin") == _read(tmp_path / "j.bin")
    assert tdata.encode_bytes(b"ab").tolist() == [97, 98]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "elastic_tpu_agent_torch.workloads.data",
         str(src), str(tmp_path / "cli.bin")],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "wrote 9 tokens" in res.stdout
    assert _read(tmp_path / "cli.bin") == _read(tmp_path / "j.bin")


# -- the warmup-cosine schedule -----------------------------------------------


@pytest.mark.parametrize("peak", [1e-3, 3e-4, 0.1])
@pytest.mark.parametrize("warmup,horizon",
                         [(2, 10), (5, 20), (1, 1), (3, 3), (10, 100), (5, 0)])
def test_schedule_matches_optax(peak, warmup, horizon):
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak, warmup_steps=warmup,
        decay_steps=max(warmup + 1, horizon), end_value=0.1 * peak,
    )
    lr = trunner.warmup_cosine_schedule(peak, warmup, horizon)
    counts = range(max(warmup + 1, horizon) + 6)
    got = np.array([lr(c) for c in counts], np.float32)
    ref = np.array([float(want(np.int32(c))) for c in counts], np.float32)
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    assert got[0] == 0.0 and got[-1] == pytest.approx(0.1 * peak, rel=1e-6)


def _assert_params_close(got, want, steps, lr, tol=1e-5, frac=1e-4):
    got = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(got)]
    want = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(want)]
    diff = [np.abs(g - w) for g, w in zip(got, want)]
    total = sum(d.size for d in diff)
    off = sum(int((d > tol).sum()) for d in diff)
    assert off <= frac * total, f"{off} of {total} elements off by > {tol}"
    assert max(float(d.max()) for d in diff) <= 2 * lr * steps + tol


def test_train_step_on_the_schedule_matches_jax():
    peak, warmup, horizon, steps = 1e-3, 2, 6, 6
    jcfg, tcfg, tree = _models()
    mesh = jt.make_mesh(1, dp=1, sp=1, tp=1)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, peak, warmup, max(warmup + 1, horizon), 0.1 * peak)
    jstep, jinit, _ = jt.make_train_step(jcfg, mesh, learning_rate=sched)
    jparams, jopt = jinit(jax.random.key(0))
    tstep, _, topt = tt.make_train_step(
        tcfg, learning_rate=trunner.warmup_cosine_schedule(
            peak, warmup, horizon), device="cpu")
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu",
                              dtype=torch.float32)
    tstate = topt.init(tparams)
    tokens = np.random.default_rng(7).integers(
        0, TINY["vocab"], size=(2, 21)).astype(np.int32)
    jl, tl = [], []
    for _ in range(steps):
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(tokens))
        jl.append(float(loss))
        tparams, tstate, loss = tstep(tparams, tstate, tokens)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _assert_params_close(params_to_jax(tparams), jax.device_get(jparams),
                         steps, peak)


# -- delta checkpoints --------------------------------------------------------


def _payload(n_blocks, block=64, stamp=b"A"):
    return b"".join(
        stamp + bytes([i % 251]) * (block - 1) for i in range(n_blocks)
    )


def _manifest(directory, step):
    with open(os.path.join(
            directory, f"manifest-{step:012d}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize(
    "payload",
    [_payload(16), _payload(4) + b"tail", b"",
     np.random.default_rng(3).bytes(5 * 1024 + 17)],
    ids=["blocks", "tail", "empty", "random"],
)
def test_delta_chain_is_the_jax_chain(tmp_path, payload):
    """The same payload gives identical manifests and block files in both
    packages; a port chain passes JAX verify() and JAX load() returns its
    bytes; a JAX chain loads in the port."""
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    ts = tck.DeltaCheckpointer(t, block_size=64).save(5, payload, round_=0)
    js = jck.DeltaCheckpointer(j, block_size=64).save(5, payload, round_=0)
    assert ts == js
    assert _manifest(t, 5) == _manifest(j, 5)
    assert sorted(os.listdir(os.path.join(t, "blocks"))) == sorted(
        os.listdir(os.path.join(j, "blocks")))
    report = jck.DeltaCheckpointer(t).verify()
    assert report["ok"] and report["chain"] == ts["chain"]
    assert tck.DeltaCheckpointer(t).verify() == report
    assert jck.DeltaCheckpointer(t).load()[0] == payload
    got, m = tck.DeltaCheckpointer(j).load()
    assert got == payload and m["chain"] == js["chain"]
    digests = _manifest(t, 5)["blocks"]
    assert tck.chain_block_digests(digests) == jck.chain_block_digests(digests)


def test_delta_rounds_ship_only_changed_blocks(tmp_path):
    d = tck.DeltaCheckpointer(str(tmp_path), block_size=64)
    payload = bytearray(_payload(16))
    s = d.save(1, bytes(payload), round_=0)
    assert s["delta_blocks"] == 16 and s["delta_bytes"] == len(payload)
    payload[0:4] = b"XXXX"
    payload[5 * 64:5 * 64 + 4] = b"YYYY"
    s = d.save(2, memoryview(bytes(payload)), round_=1)
    assert s["delta_blocks"] == 2 and s["delta_bytes"] == 2 * 64
    assert d.load(2)[0] == bytes(payload)
    s = d.save(3, bytes(payload), round_=2)
    assert s["delta_blocks"] == 0 and s["delta_bytes"] == 0
    # a fresh instance over the existing state re-reads its baseline
    payload[0:4] = b"ZZZZ"
    s = tck.DeltaCheckpointer(str(tmp_path), block_size=64).save(
        4, bytes(payload), round_=3)
    assert s["delta_blocks"] == 1
    # a JAX instance continuing the chain agrees on the baseline
    payload[64:68] = b"WWWW"
    s = jck.DeltaCheckpointer(str(tmp_path), block_size=64).save(
        5, bytes(payload), round_=4)
    assert s["delta_blocks"] == 1


def test_chain_is_order_sensitive():
    digests = ["a" * 32, "b" * 32]
    assert tck.chain_block_digests(digests) != tck.chain_block_digests(
        list(reversed(digests)))


def test_torn_manifest_is_skipped(tmp_path):
    d = tck.DeltaCheckpointer(str(tmp_path), block_size=64)
    d.save(1, _payload(8))
    with open(os.path.join(str(tmp_path), "manifest-000000000002.json"),
              "w") as f:
        f.write('{"step": 2, "blocks": [truncated')
    assert d.latest_step == 1
    got, m = d.load()
    assert got == _payload(8) and m["step"] == 1
    assert tck.DeltaCheckpointer(str(tmp_path)).verify()["step"] == 1
    assert jck.DeltaCheckpointer(str(tmp_path)).latest_step == 1


def test_corrupt_missing_and_tampered_chains_fail(tmp_path):
    d = tck.DeltaCheckpointer(str(tmp_path), block_size=64)
    d.save(1, _payload(8))
    m = d.read_manifest(1)
    victim = os.path.join(str(tmp_path), "blocks", f"{m['blocks'][3]}.bin")
    with open(victim, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(ValueError):
        d.load(1)
    for ck in (d, jck.DeltaCheckpointer(str(tmp_path))):
        report = ck.verify(1)
        assert not report["ok"]
        assert any("corrupt" in p for p in report["problems"])
    os.unlink(victim)
    assert any("missing" in p for p in d.verify(1)["problems"])

    d2 = tck.DeltaCheckpointer(str(tmp_path / "t"), block_size=64)
    d2.save(1, _payload(4))
    path = os.path.join(str(tmp_path / "t"), "manifest-000000000001.json")
    with open(path) as f:
        m = json.load(f)
    m["chain"] = "0" * 32
    with open(path, "w") as f:
        json.dump(m, f)
    for ck in (tck.DeltaCheckpointer(str(tmp_path / "t")),
               jck.DeltaCheckpointer(str(tmp_path / "t"))):
        assert not ck.verify(1)["ok"]
        with pytest.raises(ValueError):
            ck.load(1)


def test_gc_keeps_referenced_blocks(tmp_path):
    d = tck.DeltaCheckpointer(str(tmp_path), block_size=64)
    payload = bytearray(_payload(8))
    for step in range(1, 6):
        payload[0:4] = step.to_bytes(4, "little")
        d.save(step, bytes(payload), round_=step - 1)
    assert d.gc(keep_steps=2) > 0
    for step in (4, 5):
        d.load(step)
        assert d.verify(step)["ok"]
        assert jck.DeltaCheckpointer(str(tmp_path)).verify(step)["ok"]
    assert d.read_manifest(1) is None and d.latest_step == 5


# -- tree bytes ---------------------------------------------------------------


def test_tree_bytes_of_params_equal_jax():
    """The port's f32 params frame to JAX tree_to_bytes' exact bytes, and
    JAX bytes rebuild the port's params."""
    _, tcfg, tree = _models()
    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    want = jck.tree_to_bytes(tree)
    got = tck.tree_to_bytes(params)
    assert bytes(got) == want
    back = tck.bytes_to_tree(want, params)
    for a, b in zip(tt._leaves(back), tt._leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_tree_bytes_roundtrip_bit_exact():
    g = torch.Generator().manual_seed(0)
    tree = {
        "w": torch.randn(3, 37, generator=g).to(torch.bfloat16),
        "b": torch.arange(6, dtype=torch.int32).reshape(3, 2),
        "nested": [torch.tensor(2.5, dtype=torch.float64), None,
                   (np.arange(4, dtype=np.float32),)],
        "count": torch.tensor(7, dtype=torch.int32),
        "view": torch.randn(4, 6, generator=g)[:, ::2],
    }
    blob = tck.tree_to_bytes(tree)
    assert bytes(tck.tree_to_bytes(tree)) == bytes(blob)   # deterministic
    back = tck.bytes_to_tree(blob, tree)
    assert list(back) == list(tree) and back["nested"][1] is None
    assert isinstance(back["nested"][2], tuple)
    pairs = [(back[k], tree[k]) for k in ("w", "b", "count", "view")] + [
        (back["nested"][0], tree["nested"][0]),
        (back["nested"][2][0], torch.from_numpy(tree["nested"][2][0])),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bytes(tck.tree_to_bytes(got)) == bytes(tck.tree_to_bytes(want))
    # bf16 leaves are their 2-byte patterns
    w = tree["w"].view(torch.int16).numpy().tobytes()
    assert w in bytes(blob)
    with pytest.raises(ValueError, match="truncated"):
        tck.bytes_to_tree(bytes(blob)[:-1], tree)
    with pytest.raises(ValueError, match="trailing"):
        tck.bytes_to_tree(bytes(blob) + b"\x00", tree)


# -- full checkpoints ---------------------------------------------------------


def _tiny_step(**opts):
    _, tcfg, tree = _models()
    step, _, opt = tt.make_train_step(tcfg, device="cpu", **opts)
    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(1).integers(
        0, TINY["vocab"], size=(4, 17))
    return step, opt, params, tokens


def _equal_trees(a, b):
    la, lb = tck._flatten(a), tck._flatten(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_train_checkpointer_roundtrip_retention_and_ema(tmp_path):
    step, opt, params, tokens = _tiny_step(ema_decay=0.9)
    state = opt.init(params)
    params, state, _ = step(params, state, tokens)
    ck = tck.TrainCheckpointer(str(tmp_path / "ck"))
    for s in range(5):
        ck.save(s, params, state, ema=tt.ema_params(state))
    ck.wait()
    assert ck.latest_step == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3", "4"]
    like_p = tt._tree_map(lambda _, t: torch.zeros_like(t), params)
    like_s = opt.init(like_p)
    got_p, got_s, at = ck.restore(like_p, like_s)
    assert at == 4
    _equal_trees(got_p, params)
    _equal_trees(got_s, state)
    assert got_s["count"].device.type == "cpu" and int(got_s["count"]) == 1
    ema, at = ck.restore_params(like_p, item="ema")
    _equal_trees(ema, tt.ema_params(state))
    with pytest.raises(FileNotFoundError):
        ck.restore(like_p, like_s, step=0)
    # restore_params casts to the template's dtype (decode serves bf16)
    bf, _ = ck.restore_params(
        tt._tree_map(lambda _, t: t.to(torch.bfloat16), params))
    assert torch.equal(bf["embed"], params["embed"].to(torch.bfloat16))
    # a leftover temp directory of a crashed save is not a step
    os.makedirs(tmp_path / "ck" / ".9.tmp" / "params")
    assert ck.latest_step == 4
    ck.close()


def test_train_checkpointer_errors(tmp_path):
    step, opt, params, tokens = _tiny_step()
    state = opt.init(params)
    ck = tck.TrainCheckpointer(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ck.restore(params, state)
    ck.save(3, params, state)
    with pytest.raises(FileNotFoundError, match="--ema-decay"):
        ck.restore_params(params, item="ema")
    wrong = dict(params, embed=torch.zeros(5, 32))
    with pytest.raises(ValueError, match="does not match the template"):
        ck.restore_params(wrong)
    # a save whose commit fails (a file where the step directory goes)
    # surfaces at wait(), and the failed step is not a step
    (tmp_path / "ck" / "4").write_text("")
    ck.save(4, params, state)
    with pytest.raises(OSError):
        ck.wait()
    assert ck.latest_step == 3


def test_resume_matches_uninterrupted_run_bit_for_bit(tmp_path):
    """save at k, a new process restores, continues == straight through
    (test_checkpointing.py's resume test, on the port)."""
    step, opt, params, tokens = _tiny_step()
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state, tokens)
    ck = tck.TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(1, params, state)
    ck.wait()
    for _ in range(2):
        params, state, _ = step(params, state, tokens)

    step2, opt2, fresh, _ = _tiny_step()
    p2, s2, at = tck.TrainCheckpointer(str(tmp_path / "ck")).restore(
        fresh, opt2.init(fresh))
    assert at == 1
    for _ in range(2):
        p2, s2, _ = step2(p2, s2, tokens)
    _equal_trees(p2, params)
    _equal_trees(s2, state)


# -- lifecycle ----------------------------------------------------------------


def _write_spec(d, h, env):
    with open(os.path.join(d, f"{h}.json"), "w") as f:
        json.dump({"env": env}, f)


def test_checkpoint_digest_equals_jax(tmp_path):
    (tmp_path / "ck" / "sub").mkdir(parents=True)
    (tmp_path / "ck" / "data.bin").write_bytes(b"x" * 100)
    (tmp_path / "ck" / "sub" / "a").write_bytes(b"y" * 7)
    d = str(tmp_path / "ck")
    assert tlc.checkpoint_digest(d) == jlc.checkpoint_digest(d) != ""
    assert tlc.checkpoint_digest(d, max_files=1) == jlc.checkpoint_digest(
        d, max_files=1)
    assert tlc.checkpoint_digest(str(tmp_path / "none")) == \
        jlc.checkpoint_digest(str(tmp_path / "none"))


@pytest.mark.parametrize("kind,kw", [
    ("checkpoint", dict(checkpoint_dir="CK", signal="drain", world_size=2,
                        epoch=3)),
    ("precopy", dict(checkpoint_dir="CK", digest="ab" * 16,
                     extra={"round": 1, "delta_bytes": 5, "ts": -1})),
    ("resume", dict(checkpoint_dir="")),
    ("drained", dict(signal="maintenance:X")),
])
def test_acks_read_back_like_jax_acks(tmp_path, kind, kw):
    (tmp_path / "CK").mkdir()
    (tmp_path / "CK" / "w").write_bytes(b"1234")
    if kw.get("checkpoint_dir"):
        kw = dict(kw, checkpoint_dir=str(tmp_path / "CK"))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert tlc.write_checkpoint_ack(a, "h", 7, kind=kind, **kw)
    assert jlc.write_checkpoint_ack(b, "h", 7, kind=kind, **kw)
    got = jlc.read_checkpoint_ack(a, "h")
    want = jlc.read_checkpoint_ack(b, "h")
    assert got.pop("ts") > 0 and want.pop("ts") > 0
    assert got == want
    assert tlc.read_checkpoint_ack(b, "h")["kind"] == kind
    assert not os.path.exists(os.path.join(a, "ack", "h.json.tmp"))
    assert tlc.read_checkpoint_ack(a, "missing") is None
    # a file where the ack dir goes: the write fails quietly
    (tmp_path / "c").write_text("")
    assert not tlc.write_checkpoint_ack(str(tmp_path / "c"), "h", 1)


def _edge_script():
    """(env stamps in order): the sequence of test_migration.py's edge
    tests, with the pre-copy cutover added."""
    env = {"ELASTIC_TPU_SLICE_EPOCH": "0", "TPU_WORKER_HOSTNAMES": "a,b,c"}
    yield dict(env)                                        # baseline epoch
    env.update(ELASTIC_TPU_DRAIN="maintenance:X",
               ELASTIC_TPU_DRAIN_DEADLINE="99")
    yield dict(env)                                        # drain edge
    yield dict(env)                                        # same: nothing
    env["ELASTIC_TPU_CUTOVER"] = "maintenance:X:2"
    yield dict(env)                                        # cutover edge
    yield dict(env)
    env["ELASTIC_TPU_THROTTLE"] = "overcommit"             # throttle mid-drain
    env["ELASTIC_TPU_THROTTLE_DEADLINE"] = "123"
    yield dict(env)
    del env["ELASTIC_TPU_DRAIN"], env["ELASTIC_TPU_CUTOVER"]
    yield dict(env)                                        # drain cancelled
    env["ELASTIC_TPU_DRAIN"] = "preemption"
    yield dict(env)                                        # re-armed edge
    env.update(ELASTIC_TPU_SLICE_EPOCH="1", TPU_WORKER_HOSTNAMES="a,b")
    yield dict(env)                                        # reform
    env["ELASTIC_TPU_SLICE_EPOCH"] = "garbage"
    yield dict(env)
    yield {}                                               # unreadable env


def test_watcher_edges_match_jax(tmp_path):
    """Both watchers see the same stamps and report the same edges,
    draining flags and ack world sizes."""
    d = str(tmp_path)
    tw = tlc.LifecycleWatcher(d, "t", poll_interval_s=0.0)
    jw = jlc.LifecycleWatcher(d, "j", poll_interval_s=0.0)
    seen = []
    for env in _edge_script():
        row = []
        for h, w in (("t", tw), ("j", jw)):
            _write_spec(d, h, env)
            sig = w.poll(force=True)
            row.append(None if sig is None else (
                sig.kind, sig.value, sig.deadline_ts, sig.epoch,
                w.draining))
            row.append(w.draining)
        assert row[0:2] == row[2:4], env
        seen.append(row[0] and row[0][0])
    assert seen == [None, "drain", None, "cutover", None, "throttle", None,
                    "drain", "reform", None, None]
    assert tw.signals_seen == jw.signals_seen == 5
    for h in ("t", "j"):
        _write_spec(d, h, {"TPU_WORKER_HOSTNAMES": "a,b"})
    assert tw.ack(4) and jw.ack(4)
    assert tlc.read_checkpoint_ack(d, "t")["world_size"] == \
        jlc.read_checkpoint_ack(d, "j")["world_size"] == 2


def test_watcher_checkpoint_fn_rate_limit_and_restore(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "w.bin").write_text("weights")
    calls = []

    def checkpoint(sig):
        calls.append(sig.kind)
        return 41, str(ck)

    now = [0.0]
    w = tlc.LifecycleWatcher(d, "h2", checkpoint_fn=checkpoint,
                             poll_interval_s=1.0, time_fn=lambda: now[0])
    _write_spec(d, "h2", {"TPU_WORKER_HOSTNAMES": "a,b"})
    assert w.poll() is None
    _write_spec(d, "h2", {"TPU_WORKER_HOSTNAMES": "a,b",
                          "ELASTIC_TPU_DRAIN": "preemption"})
    assert w.poll() is None          # rate-limited
    now[0] = 1.5
    assert w.poll().kind == tlc.SIGNAL_DRAIN and calls == ["drain"]
    ack = jlc.read_checkpoint_ack(d, "h2")
    assert ack["step"] == 41 and ack["world_size"] == 2
    assert ack["signal"] == "preemption"
    assert ack["digest"] == jlc.checkpoint_digest(str(ck))
    # the restore stamp: spec env first, ambient env as fallback
    assert w.restore_request() is None
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_DIR", "/ambient")
    monkeypatch.setenv("ELASTIC_TPU_RESTORE_STEP", "x")
    assert w.restore_request() == {"checkpoint_dir": "/ambient",
                                   "step": None, "trace": ""}
    _write_spec(d, "h2", {"ELASTIC_TPU_RESTORE_DIR": "/ck",
                          "ELASTIC_TPU_RESTORE_STEP": "12",
                          "ELASTIC_TPU_RESTORE_TRACE": "tr"})
    assert w.restore_request() == {"checkpoint_dir": "/ck", "step": 12,
                                   "trace": "tr"}
    assert w.restore_request() == jlc.LifecycleWatcher(
        d, "h2").restore_request()


def test_watcher_disabled_outside_contract(monkeypatch):
    for name in ("TPU", "GPU", "ELASTIC_TPU_ALLOC_DIR"):
        monkeypatch.delenv(name, raising=False)
    w = tlc.LifecycleWatcher()
    assert not w.enabled and w.poll(force=True) is None
    assert w.ack(1) is False and w.read_env() == {}
    monkeypatch.setenv("GPU", "legacy")
    monkeypatch.setenv("ELASTIC_TPU_ALLOC_DIR", "/alloc")
    w = tlc.LifecycleWatcher()
    assert w.enabled and w.alloc_hash == "legacy"


def test_drain_serving_matches_jax(tmp_path):
    """drain_serving over the port's engine steps, drains and acks as the
    JAX one does over the JAX engine (float32, greedy)."""
    base = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=96)
    jcfg = jt.ModelConfig(**base, dtype=jnp.float32, attn="reference")
    tcfg = tt.ModelConfig(**base, dtype=torch.float32)
    tree = jt.init_params(jcfg, jax.random.key(0))
    kw = dict(slots=2, max_len=24, prompt_buckets=(8,), block_size=4)
    engines = (
        jserving.ServingEngine(tree, jcfg, **kw),
        tserving.ServingEngine(params_from_jax(tree, tcfg, device="cpu"),
                               tcfg, device="cpu", **kw),
    )
    summaries = []
    for eng, lc, h in zip(engines, (jlc, tlc), ("j", "t")):
        eng.admit([5, 17, 42, 9])
        eng.enqueue([61, 3, 88, 24, 7, 7, 13, 2, 90, 41, 5])
        eng.step()
        w = lc.LifecycleWatcher(str(tmp_path), h)
        summaries.append(lc.drain_serving(eng, w, lc.Signal("drain", "op")))
        ack = jlc.read_checkpoint_ack(str(tmp_path), h)
        assert ack["kind"] == "drained" and ack["signal"] == "op"
    assert summaries[0] == summaries[1]
    assert summaries[1]["live_requests"] == 0 and summaries[1]["steps"] > 0
    # handoff=True over a SharedKVPool: the pending prefill is pumped,
    # both open streams are published, and the ack carries their count
    summaries, acks = [], []
    for mod, lc, params, cfg, dev, h in (
        (jserving, jlc, tree, jcfg, {}, "jh"),
        (tserving, tlc, params_from_jax(tree, tcfg, device="cpu"), tcfg,
         dict(device="cpu"), "th"),
    ):
        pool = mod.SharedKVPool(cfg, block_size=4, pool_blocks=32, **dev)
        eng = mod.ServingEngine(params, cfg, **kw, pool=pool, **dev)
        eng.admit([5, 17, 42, 9])
        eng.enqueue([61, 3, 88, 24, 7, 7, 13, 2, 90, 41, 5])
        eng.step()
        w = lc.LifecycleWatcher(str(tmp_path), h)
        summaries.append(lc.drain_serving(eng, w, lc.Signal("drain", "op"),
                                          handoff=True))
        ack = jlc.read_checkpoint_ack(str(tmp_path), h)
        acks.append({k: v for k, v in ack.items() if k != "ts"})
        assert pool.pending_streams == 2 and eng.used_blocks > 0
    assert summaries[0] == summaries[1]
    assert summaries[1]["handoff_streams"] == 2
    assert acks[0] == acks[1] and acks[1]["handoff_streams"] == 2
    assert acks[1]["kind"] == "drained"


# -- telemetry ----------------------------------------------------------------


def test_flight_recorder_records_rotates_and_summarises(tmp_path, monkeypatch):
    monkeypatch.setenv("ELASTIC_TPU_TRACE_ID", "trace-1")
    path = str(tmp_path / "fr" / "steps.jsonl")
    rec = ttel.FlightRecorder(path=path, max_bytes=600, device="cpu")
    for i in range(6):
        with rec.step(i, tokens=64, phase="train") as t:
            t.set(note=i)
    rec.record("eval", step=5, loss=1.5)
    with pytest.raises(RuntimeError):
        with rec.step(6):
            raise RuntimeError("boom")
    s = rec.summary()
    assert s["trace_id"] == "trace-1" and s["path"] == path
    assert s["steps"] == 7 and s["records"] == 8
    assert s["jit_recompiles"] is None         # eager: nothing compiled
    assert s["mean_tokens_per_s"] > 0 and s["mean_step_ms"] >= 0
    rec.close()
    assert os.path.exists(path + ".1")          # rotated past max_bytes
    back = ttel.load_jsonl(path)
    assert back == jtel.load_jsonl(path)
    assert [r["kind"] for r in back][-2:] == ["eval", "step"]
    assert back[-1]["error"] == "RuntimeError: boom"
    steps = [r for r in back if r["kind"] == "step"]
    assert all("jit_recompiles" not in r and "device_memory" not in r
               for r in steps)
    assert all(r["trace_id"] == "trace-1" for r in back)
    assert ttel.FlightRecorder().summary()["path"] is None


def test_device_memory_stats_without_a_card():
    assert ttel.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert ttel.device_memory_stats() is None


def test_sidecar_files_equal_jax(tmp_path):
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    for mod, d in ((ttel, t), (jtel, j)):
        assert mod.write_usage_report(d, "h", 42.5, 1 << 30, ts=5.0)
        assert mod.write_flight_summary(d, "h", 1234.5, steps=9,
                                        mean_step_ms=3.5, ttft_p50_s=0.25,
                                        ts=6.0)
    for sub in ("usage", "flight"):
        a = (tmp_path / "t" / sub / "h.json").read_text()
        b = (tmp_path / "j" / sub / "h.json").read_text()
        assert json.loads(a) == json.loads(b)
    (tmp_path / "x").write_text("")
    assert not ttel.write_usage_report(str(tmp_path / "x"), "h", 1.0)


def test_workloads_package_exports_the_runtime():
    w = importlib.import_module("elastic_tpu_agent_torch.workloads")
    for mod, names in (
        (tck, ("TrainCheckpointer", "DeltaCheckpointer", "tree_to_bytes",
               "bytes_to_tree")),
        (tlc, ("LifecycleWatcher", "drain_serving")),
        (ttel, ("FlightRecorder",)),
        (tdata, ("TokenDataset", "write_token_file")),
    ):
        for name in names:
            assert getattr(w, name) is getattr(mod, name)
