"""ServingEngine of the PyTorch port (elastic_tpu_agent_torch/workloads/
serving.py) against the JAX engine: greedy streams are token-exact
through interleaved admit()s, slot reuse and enqueue() chunked prefill,
on the port's gather path and on its paged-kernel path (on the CPU the
kernel path runs the paged kernel's plain version), for dense and MoE
models and for the int8 KV pool; the flight records and the drain
refusal equal the JAX engine's; the sampling generator advances on every
step. float32 weights."""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import lifecycle as jlc  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import telemetry as jtel  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import lifecycle as tlc  # noqa: E402
from elastic_tpu_agent_torch.workloads import moe as tm  # noqa: E402
from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)
ENGINE = dict(slots=3, max_len=64, prompt_buckets=(8,), block_size=4)


def _models(**kw):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, **kw)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _drive(eng):
    """Interleaved sync and chunked admissions with slot reuse; returns
    every request's stream and finish reason, in admission order."""
    rids = [eng.admit([5, 17, 42, 9])]
    for _ in range(3):
        eng.step()
    rids.append(eng.enqueue([61, 3, 88, 24, 7, 7, 13, 2, 90, 41, 5]))
    for _ in range(4):
        eng.step()
    out = [eng.release(rids[0])]           # frees slot 0 mid-flight
    rids.append(eng.admit([3, 88]))        # reuses it
    rids.append(eng.enqueue([44, 1, 2, 3, 4]))
    for _ in range(7):
        eng.step()
    reasons = [eng.finish_reason.get(r) for r in rids[1:]]
    out += [eng.release(r) for r in rids[1:]]
    return out, reasons


@pytest.mark.parametrize(
    "kw,jax_paged",
    [
        (dict(pos="rope"), False),
        (dict(n_kv_heads=2), True),
        (dict(pos="rope", window=6), False),
        (dict(moe_experts=4), False),
        (dict(moe_experts=4, n_kv_heads=2, pos="rope"), True),
    ],
    ids=["mha-rope", "gqa-learned-jaxkernel", "rope-window", "moe4",
         "moe4-gqa-rope-jaxkernel"],
)
def test_streams_token_exact_vs_jax_engine(kw, jax_paged):
    """The JAX side runs its gather path, or (jax_paged) its Pallas paged
    kernel in interpret mode."""
    jcfg, tcfg, tree, params = _models(**kw)
    want = _drive(
        js.ServingEngine(tree, jcfg, **ENGINE, paged_kernel=jax_paged)
    )
    assert all(len(s) >= 4 for s in want[0])
    for paged in (False, True):
        eng = ts.ServingEngine(
            params, tcfg, **ENGINE, paged_kernel=paged, device="cpu"
        )
        assert _drive(eng) == want, f"paged_kernel={paged}"
        assert eng.used_blocks == 0


def test_max_len_and_stop_tokens_match_jax():
    jcfg, tcfg, tree, params = _models(pos="rope")

    def run(eng):
        ra = eng.admit([5, 17, 42, 9, 1, 2, 3])
        probe = eng.stream(ra)[0]
        rb = eng.admit([61, 3], stop_tokens=())
        for _ in range(8):
            eng.step()
        sb = eng.stream(rb)
        rc = eng.admit([61, 3], stop_tokens=(sb[3],))
        for _ in range(6):
            eng.step()
        return (
            probe, [eng.finish_reason.get(r) for r in (ra, rb, rc)],
            [eng.release(r) for r in (ra, rb, rc)],
        )

    small = dict(ENGINE, max_len=12)
    want = run(js.ServingEngine(tree, jcfg, **small))
    got = run(ts.ServingEngine(params, tcfg, **small, device="cpu"))
    assert got == want
    assert want[1][0] == "max_len" and want[1][2] == "stop_token"


def test_sampled_rows_gather_and_kernel_paths_agree():
    """Mixed greedy and sampled requests: the two decode paths consume
    the engine's generator identically and compute the same logits to
    float noise, so whole streams agree."""
    _, tcfg, _, params = _models()

    def run(paged):
        eng = ts.ServingEngine(
            params, tcfg, **ENGINE, paged_kernel=paged, seed=11,
            device="cpu",
        )
        rg = eng.admit([5, 17, 42])
        rs = eng.admit([61, 3], temperature=0.9, top_k=12)
        rp = eng.enqueue([7, 8, 9, 10, 11], temperature=1.1, top_p=0.8)
        for _ in range(8):
            eng.step()
        return [eng.release(r) for r in (rg, rs, rp)]

    a, b = run(False), run(True)
    assert a == b
    assert len(a[2]) >= 5


def test_pool_exhaustion_finishes_rows():
    _, tcfg, _, params = _models()
    eng = ts.ServingEngine(
        params, tcfg, **ENGINE, pool_blocks=6, device="cpu"
    )
    ra = eng.admit([1, 2, 3, 4, 5, 6, 7])   # 2 blocks
    rb = eng.admit([1, 2, 3, 4, 5, 6, 7])   # 2 blocks
    for _ in range(6):
        eng.step()
    assert "pool_exhausted" in (
        eng.finish_reason.get(ra), eng.finish_reason.get(rb)
    )
    eng.release(ra), eng.release(rb)
    assert eng.used_blocks == 0
    with pytest.raises(ValueError, match="exhausted"):
        eng.enqueue([1] * 30)               # 8 blocks, the pool has 5
    assert eng.used_blocks == 0 and eng.stats()["pending_prefills"] == 0


def test_admission_guards_and_stats():
    _, tcfg, _, params = _models()
    eng = ts.ServingEngine(params, tcfg, **ENGINE, device="cpu")
    assert eng.paged_kernel is False  # auto resolves ON only for CUDA
    with pytest.raises(ValueError, match="bucket"):
        eng.admit(list(range(9)))
    with pytest.raises(ValueError, match="empty"):
        eng.admit([])
    rids = [eng.admit([1, 2]) for _ in range(3)]
    with pytest.raises(ValueError, match="no free slot"):
        eng.admit([1])
    st = eng.stats()
    assert st["live_requests"] == 3 and st["used_blocks"] == 3
    assert st["prefilled_tokens_total"] == 6
    eng.release(rids[0])
    pending = eng.enqueue([1, 2, 3, 4, 5])
    assert eng.stream(pending) == [] and eng.stats()["pending_prefills"] == 1
    assert eng.release(pending) == []
    assert eng.used_blocks == 2


@pytest.mark.parametrize(
    "opt", [dict(mesh=object()), dict(draft_params={})],
)
def test_later_slice_options_raise(opt):
    _, tcfg, _, params = _models()
    with pytest.raises(NotImplementedError, match="later slice"):
        ts.ServingEngine(params, tcfg, **ENGINE, device="cpu", **opt)


@pytest.mark.parametrize("method", ["admit", "enqueue"])
def test_admission_signature_matches_jax(method):
    """admit/enqueue take the JAX engine's parameters in its order, so a
    second positional argument is a prefix id on both sides (it once
    set the port's temperature)."""
    import inspect

    jcfg, tcfg, tree, params = _models(pos="rope")
    names = [list(inspect.signature(getattr(cls, method)).parameters)
             for cls in (js.ServingEngine, ts.ServingEngine)]
    assert names[0] == names[1]
    assert names[1][:3] == ["self", "prompt", "prefix"]

    def run(eng):
        pid = eng.register_prefix([7, 7, 30, 2, 51, 11])
        rid = getattr(eng, method)([5, 17, 42], pid)
        while len(eng.stream(rid)) < 5:
            eng.step()
        with pytest.raises(ValueError, match="unknown or released prefix"):
            getattr(eng, method)([5], pid + 7)
        return eng.release(rid), eng.stats()["admitted_tokens_total"]

    want = run(js.ServingEngine(tree, jcfg, **ENGINE))
    assert run(ts.ServingEngine(params, tcfg, **ENGINE, device="cpu")) == want
    assert want[1] == 9


def test_unknown_option_and_device_mismatch():
    _, tcfg, _, params = _models()
    with pytest.raises(TypeError):
        ts.ServingEngine(params, tcfg, **ENGINE, device="cpu", bogus=1)
    with pytest.raises(ValueError, match="params live on"):
        ts.ServingEngine(params, tcfg, **ENGINE, device="meta")


def test_block_allocator_refcounts():
    a = ts.BlockAllocator(4)
    b1, b2 = a.alloc(), a.alloc()
    assert {b1, b2} <= {1, 2, 3} and a.used == 2
    a.share(b1)
    a.drop(b1)
    assert a.used == 2
    a.drop(b1), a.drop(b2)
    assert a.used == 0
    assert ts.gather_bucket(3, 16) == 4 and ts.gather_bucket(9, 8) == 8


@pytest.mark.parametrize("kw", [dict(pos="rope"), dict(moe_experts=4)],
                         ids=["mha-rope", "moe4"])
def test_kv_int8_streams_token_exact_vs_jax_engine(kw):
    """The int8 pool (quantize on every write, dequantize after every
    gather) on the gather path, against the JAX kv_int8 engine."""
    jcfg, tcfg, tree, params = _models(**kw)
    want = _drive(js.ServingEngine(tree, jcfg, **ENGINE, kv_int8=True))
    eng = ts.ServingEngine(params, tcfg, **ENGINE, kv_int8=True,
                           device="cpu")
    assert not eng.paged_kernel and eng.stats()["kv_int8"] is True
    assert eng._pool_k["q"].dtype == torch.int8
    assert eng._pool_k["s"].shape == eng._pool_k["q"].shape[:-1] + (1,)
    assert _drive(eng) == want
    assert eng.used_blocks == 0
    # the pool holds per-position int8: within half a step of the float
    # pool's entries, and not equal to them
    pools = []
    for int8 in (True, False):
        e = ts.ServingEngine(params, tcfg, **ENGINE, kv_int8=int8,
                             device="cpu")
        e.admit([5, 17, 42, 9, 1, 2, 3])
        pools.append(ts._pool_get(e._pool_k, (slice(None), [1, 2])))
    step = pools[1].abs().amax(-1, keepdim=True) / 127.0
    assert ((pools[0] - pools[1]).abs() <= 0.5 * step + 1e-7).all()
    assert not torch.equal(pools[0], pools[1])


def test_kv_int8_refuses_the_paged_kernel():
    jcfg, tcfg, tree, params = _models()
    with pytest.raises(ValueError, match="mutually exclusive"):
        js.ServingEngine(tree, jcfg, **ENGINE, kv_int8=True,
                         paged_kernel=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.ServingEngine(params, tcfg, **ENGINE, kv_int8=True,
                         paged_kernel=True, device="cpu")


def test_moe_stats_in_engine_stats():
    _, tcfg, _, params = _models(moe_experts=4)
    eng = ts.ServingEngine(params, tcfg, **ENGINE, device="cpu")
    assert "moe" not in eng.stats() and eng.moe_stats is None
    eng.moe_stats = tm.MoeRoutingStats()
    x = torch.randn(2, 5, BASE["d_model"], generator=torch.Generator()
                    .manual_seed(0))
    eng.moe_stats.observe(x, params["layers"][1]["moe"], 1.25)
    assert eng.stats()["moe"] == eng.moe_stats.stats()
    assert eng.stats()["moe"]["tokens_routed"] == 10


def _b_stream(eng, temp_a):
    """A at temperature temp_a for 3 steps, then B sampled at temperature
    1.0 for 6 steps; returns B's 7 tokens. Before the generator advanced
    on every step, the port gave B [56, 41, 68, 40, 69, 70, 42] after a
    greedy A and [89, 69, 27, 42, 60, 43, 16] after a sampled one."""
    ra = eng.admit([5, 17, 42, 9], temperature=temp_a)
    for _ in range(3):
        eng.step()
    eng.release(ra)
    rb = eng.admit([3, 88, 1], temperature=1.0)
    for _ in range(6):
        eng.step()
    return eng.release(rb)


def test_sampling_draws_do_not_depend_on_neighbours():
    """The generator advances on every plain step, as the JAX engine
    splits its key, so B's sampled stream is the same whether A sampled
    or was greedy, in both engines."""
    jcfg, tcfg, tree, params = _models()
    for make in (
        lambda: js.ServingEngine(tree, jcfg, **ENGINE, seed=3),
        lambda: ts.ServingEngine(params, tcfg, **ENGINE, seed=3,
                                 device="cpu"),
    ):
        greedy_a, sampled_a = _b_stream(make(), 0.0), _b_stream(make(), 1.0)
        assert len(greedy_a) == 7 and greedy_a == sampled_a


def _trace(eng):
    """An admit/enqueue/step trace with slo annotations (one unknown)."""
    ra = eng.admit([5, 17, 42, 9], slo="ttft")
    eng.step()
    rb = eng.enqueue([61, 3, 88, 24, 7, 7], slo="tpot")
    for _ in range(3):
        eng.step()
    eng.release(ra)
    eng.admit([3, 88], slo="bogus", stop_tokens=(1,))
    for _ in range(2):
        eng.step()
    eng.release(rb)
    eng.step()


def test_flight_records_match_jax_engine():
    """One serving_admit per admission and one serving_step per step,
    with the JAX engine's fields and values (duration_ms apart)."""
    jcfg, tcfg, tree, params = _models()
    jrec = jtel.FlightRecorder(path="", trace_id="")
    trec = ttel.FlightRecorder(path="", trace_id="")
    _trace(js.ServingEngine(tree, jcfg, **ENGINE, recorder=jrec))
    _trace(ts.ServingEngine(params, tcfg, **ENGINE, recorder=trec,
                            device="cpu"))

    def strip(records):
        out = []
        for r in records:
            assert r["duration_ms"] >= 0
            out.append({k: v for k, v in r.items()
                        if k not in ("ts", "duration_ms")})
        return out

    want = strip(jrec.records)
    assert strip(trec.records) == want
    kinds = [r["kind"] for r in want]
    assert kinds.count("serving_admit") == 2
    assert kinds.count("serving_step") == 7
    assert [r["slo"] for r in want if r["kind"] == "serving_admit"] == [
        "ttft", "batch"]


def _spec(alloc, env):
    with open(os.path.join(alloc, "h1.json"), "w") as f:
        f.write(__import__("json").dumps({"env": env}))


@pytest.mark.parametrize("side", ["jax", "port"])
def test_draining_watcher_refuses_admission_and_drains(side, tmp_path):
    """Once the spec carries a drain stamp, admit() and enqueue() raise
    ValueError; drain_serving finishes the streams and acks."""
    jcfg, tcfg, tree, params = _models()
    alloc = str(tmp_path)
    _spec(alloc, {})
    lc = jlc if side == "jax" else tlc
    watcher = lc.LifecycleWatcher(alloc, "h1", poll_interval_s=0.0)
    if side == "jax":
        eng = js.ServingEngine(tree, jcfg, **dict(ENGINE, max_len=16),
                               lifecycle=watcher)
    else:
        eng = ts.ServingEngine(params, tcfg, **dict(ENGINE, max_len=16),
                               lifecycle=watcher, device="cpu")
    ra = eng.admit([5, 17, 42])
    eng.enqueue([61, 3, 88, 24, 7])
    eng.step()
    _spec(alloc, {"ELASTIC_TPU_DRAIN": "maintenance:X"})
    with pytest.raises(ValueError, match="draining"):
        eng.admit([1, 2])
    with pytest.raises(ValueError, match="draining"):
        eng.enqueue([1, 2])
    summary = lc.drain_serving(eng, watcher)
    assert summary["live_requests"] == 0 and summary["drained_tokens"] > 0
    assert eng.finish_reason[ra] == "max_len"
    ack = lc.read_checkpoint_ack(alloc, "h1")
    assert ack["kind"] == "drained"
