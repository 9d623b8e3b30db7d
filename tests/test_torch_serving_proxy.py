"""The port's decode-step traffic model and paged-kernel rule
(``elastic_tpu_agent_torch/workloads/serving_proxy.py``) against the JAX
package's ``serving_proxy.py``, on the CPU: the traffic dict equal key for
key and value for value, the threshold's cases, the engine's auto default
resolving through the rule, the report's JAX keys, and the measured costs
(``xla_measured_costs``: the port's dispatch tallies under JAX's keys,
held against the paged kernel's own traffic model). Mirrors
``tests/test_serving_proxy.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elastic_tpu_agent.workloads import serving_proxy as jsp  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    paged_attention as tpa,
    serving as ts,
    serving_proxy as tsp,
)
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.generate import generate  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=96)
SMALL = dict(vocab=32768, d_model=512, n_heads=8, n_layers=8, d_ff=2048)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="f32", **kw):
    jd, td = DTYPES[dtype]
    return (jt.ModelConfig(**dict(BASE, **kw), dtype=jd),
            tt.ModelConfig(**dict(BASE, **kw), dtype=td))


@pytest.mark.parametrize("slots,seq", [(4, 64), (8, 512), (16, 48)])
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("variant", [
    dict(), dict(n_kv_heads=2), dict(dtype="bf16")])
def test_traffic_dict_equals_jax(slots, seq, kv_int8, variant):
    """Key for key and value for value, at the JAX test's three operating
    points, float and int8 pools, MHA, GQA and bf16 storage."""
    jcfg, tcfg = _cfgs(**variant)
    kw = dict(slots=slots, seq_len=seq, kv_int8=kv_int8)
    assert (tsp.decode_step_traffic(tcfg, **kw)
            == jsp.decode_step_traffic(jcfg, **kw))


def test_traffic_model_ratio_is_structural_3x():
    _, cfg = _cfgs()
    for slots, seq in ((4, 64), (8, 512), (16, 48)):
        est = tsp.decode_step_traffic(cfg, slots=slots, seq_len=seq)
        assert 2.5 < est["kv_bytes_ratio"] <= 3.0, est
        assert est["ops_ratio"] == 1.0
        assert est["gather"]["flops"] == est["paged"]["flops"]
        assert 1.0 < est["total_bytes_ratio"] <= est["kv_bytes_ratio"]


def test_paged_term_is_the_kernel_traffic_full_sweep():
    """The paged term reads the port's kernel_traffic: with every table
    entry full and no window its kv_bytes_read is JAX's formula."""
    for slots, nb, bs, g, h, item in ((8, 32, 16, 8, 64, 2),
                                      (3, 5, 4, 2, 8, 4)):
        got = tpa.kernel_traffic(slots, nb, bs, g, h, item)["kv_bytes_read"]
        assert got == slots * g * nb * bs * h * item * 2


def test_recommendation_follows_documented_threshold():
    """The four cases: on natively, off where the kernel runs its plain
    version, off under an int8 pool or a mesh."""
    _, cfg = _cfgs()
    assert tsp.recommend_paged_kernel(cfg, interpret=False) is True
    assert tsp.recommend_paged_kernel(cfg, interpret=True) is False
    assert tsp.recommend_paged_kernel(cfg, kv_int8=True) is False
    assert tsp.recommend_paged_kernel(cfg, mesh=object()) is False
    assert tsp.recommend_paged_kernel(None) is True
    assert (tsp.decode_step_traffic(cfg)["kv_bytes_ratio"]
            >= tsp.PAGED_DEFAULT_MIN_RATIO == jsp.PAGED_DEFAULT_MIN_RATIO)


def test_engine_auto_default_resolves_off_on_cpu():
    """paged_kernel=None on CPU tensors keeps the gather path, and the
    engine still serves generate()'s stream."""
    jcfg, cfg = _cfgs(pos="rope")
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    params = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    eng = ts.ServingEngine(params, cfg, slots=1, max_len=64,
                           prompt_buckets=(8,), block_size=4,
                           paged_kernel=None, device="cpu")
    assert eng.paged_kernel is False
    rid = eng.admit([5, 17, 42])
    for _ in range(3):
        eng.step()
    want = generate(params, [[5, 17, 42]], cfg, 4, device="cpu")
    assert eng.release(rid) == want[0, 3:].tolist()


def test_engine_resolves_through_the_rule(monkeypatch):
    """The engine asks the rule with its own shape, in JAX's order: a
    shared pool forces the gather path before the rule is asked, and
    kv_int8 and the mesh refuse an explicit kernel with JAX's messages."""
    _, cfg = _cfgs()
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []

    def rule(*args, **kw):
        calls.append(kw)
        return True

    monkeypatch.setattr(ts, "recommend_paged_kernel", rule)
    eng = ts.ServingEngine(params, cfg, slots=3, max_len=64,
                           prompt_buckets=(8,), block_size=4, device="cpu")
    assert eng.paged_kernel is True      # the rule's answer, on CPU too
    assert calls == [dict(interpret=True, kv_int8=False, mesh=None,
                          slots=3, seq_len=64, block_size=4)]
    pool = ts.SharedKVPool(cfg, block_size=4, pool_blocks=40, device="cpu")
    eng = ts.ServingEngine(params, cfg, slots=1, max_len=64,
                           prompt_buckets=(8,), pool=pool, device="cpu")
    assert eng.paged_kernel is False and len(calls) == 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.ServingEngine(params, cfg, slots=1, max_len=64,
                         prompt_buckets=(8,), kv_int8=True,
                         device="cpu")


def test_phase4_shape_resolves_on():
    """chip_smoke's phase-4 engine (the small preset in bf16, 8 slots,
    max_len 512, block 16): the ratio is (3V + W) / (V + W) with V / W =
    512, about 2.996, so the kernel resolves on natively."""
    cfg = tt.ModelConfig(**SMALL)
    jcfg = jt.ModelConfig(**SMALL)
    kw = dict(slots=8, seq_len=512, block_size=16)
    est = tsp.decode_step_traffic(cfg, max_len=512, **kw)
    assert est == jsp.decode_step_traffic(jcfg, max_len=512, **kw)
    assert est["kv_bytes_ratio"] == round(1537 / 513, 3) == 2.996
    assert tsp.recommend_paged_kernel(cfg, **kw) is True


def test_serving_proxy_report_matches_jax():
    """JAX's keys with JAX's values (the rule's wording names the CUDA
    device, and the measured costs are the port's dispatch tallies under
    JAX's keys and shape), the dtype string as numpy spells it, and the
    one extra key: the Hopper kernel's split-K traffic at the operating
    point."""
    want = jsp.serving_proxy_report()
    got = tsp.serving_proxy_report()
    assert set(got) == set(want) | {"hopper_split_k"}
    for key in set(want) - {"paged_kernel_default", "xla_cost_analysis"}:
        assert got[key] == want[key], key
    assert got["operating_point"]["model"]["dtype"] == "bfloat16"
    pk, jpk = got["paged_kernel_default"], want["paged_kernel_default"]
    assert set(pk) == set(jpk)
    assert (pk["tpu_native"], pk["cpu_interpret"]) == (True, False)
    assert "CUDA device" in pk["rule"]
    xla, jxla = got["xla_cost_analysis"], want["xla_cost_analysis"]
    assert set(xla) == set(jxla) == {"shape", "gather_reference",
                                     "paged_interpret"}
    assert xla["shape"] == jxla["shape"]
    assert "error" not in xla
    split = got["hopper_split_k"]
    cfg = tt.ModelConfig(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
                         d_ff=8192, max_seq=1024)
    nb = 512 // 32
    kt = tpa.kernel_traffic(8, nb, 32, cfg.kv_heads, cfg.head_dim, 2,
                            n_heads=cfg.n_heads,
                            splits=tpa.paged_splits(8, cfg.kv_heads, nb))
    assert split == dict(splits=tpa.paged_splits(8, cfg.kv_heads, nb),
                         calls_per_step=8, bytes=kt["bytes"],
                         partial_bytes=kt["partial_bytes"],
                         kernel_bytes=kt["kernel_bytes"])
    jcfg, tcfg = _cfgs()
    f32, jf32 = tsp.serving_proxy_report(tcfg), jsp.serving_proxy_report(jcfg)
    assert f32["operating_point"] == jf32["operating_point"]
    assert f32["int8_kv"] == jf32["int8_kv"]
    assert f32["operating_point"]["model"]["dtype"] == "float32"


def test_xla_measured_costs_keys_and_the_kernel_model():
    """JAX's function and the port's at JAX's default shape and inputs:
    the same keys and shape, both legs nonzero on both sides. The port's
    counts are dispatch tallies, not XLA's, so they are held against the
    kernel's own model: the reference's flops are kernel_traffic's for a
    full table (8,192), the emulation's are 4 * bs * n * h for each block
    the kernel streams at the drawn lengths (12 blocks: 6,144, at least
    the 5,120 of the attended positions), and each leg moves at least the
    bytes the function needs."""
    want = jsp.xla_measured_costs()
    got = tsp.xla_measured_costs()
    assert set(got) == set(want)
    assert got["shape"] == want["shape"] == dict(
        slots=4, kv_heads=2, q_per_kv=2, head_dim=8, block_size=4,
        table_blocks=4)
    for side in (got, want):
        for leg in ("gather_reference", "paged_interpret"):
            assert set(side[leg]) == {"bytes_accessed", "flops"}
            assert side[leg]["bytes_accessed"] > 0 and side[leg]["flops"] > 0
    shape = got["shape"]
    slots, g, nb, bs = (shape[k] for k in ("slots", "kv_heads",
                                           "table_blocks", "block_size"))
    h, n = shape["head_dim"], g * shape["q_per_kv"]
    rng = np.random.default_rng(0)      # JAX's draws, in JAX's order
    for size in ((slots, n, h), (17, bs, g, h), (17, bs, g, h)):
        rng.normal(size=size)
    rng.integers(1, 17, size=(slots, nb))
    lengths = rng.integers(1, nb * bs + 1, size=(slots,)).tolist()
    assert lengths == [10, 5, 11, 14]
    full = tpa.kernel_traffic(slots, nb, bs, g, h, 4, n_heads=n)
    drawn = tpa.kernel_traffic(slots, nb, bs, g, h, 4, n_heads=n,
                               lengths=lengths)
    assert got["gather_reference"]["flops"] == full["flops"] == 8192
    streamed = 4 * bs * (drawn["blocks_streamed"] // g) * n * h
    assert got["paged_interpret"]["flops"] == streamed == 6144
    assert streamed >= drawn["flops"] == 5120
    assert got["gather_reference"]["bytes_accessed"] >= full["bytes"]
    assert got["paged_interpret"]["bytes_accessed"] >= drawn["bytes"]


def test_report_falls_back_to_an_error_as_jax_does(monkeypatch):
    """A tally that raises leaves the report whole, with JAX's error
    form in its place."""
    def boom():
        raise RuntimeError("no dispatch")

    monkeypatch.setattr(tsp, "xla_measured_costs", boom)
    assert tsp.serving_proxy_report()["xla_cost_analysis"] == {
        "error": "RuntimeError: no dispatch"}
