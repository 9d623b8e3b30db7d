"""KV-cache decode of the PyTorch port (elastic_tpu_agent_torch/workloads/
generate.py) against the JAX package: greedy generate is token-exact,
MoE models and int8 weights included;
sampling is checked through the injected-uniforms seam and by
distribution (jax.random and torch.Generator streams differ)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import quantize as tq  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

# the packages re-export the function `generate`, which shadows the module
jg = importlib.import_module("elastic_tpu_agent.workloads.generate")
tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)


def _models(**kw):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, **kw)
    tree = jt.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(n_kv_heads=2, pos="rope"), dict(pos="rope", window=6),
     dict(n_kv_heads=2, pos="rope", window=6),
     dict(moe_experts=4), dict(moe_experts=2, moe_every=1, pos="rope")],
    ids=["mha-learned", "gqa-rope", "rope-window", "gqa-rope-window", "moe4",
         "moe2-all-rope"],
)
def test_greedy_generate_token_exact(monkeypatch, kw):
    """On the CPU the prompt pass from position 0 keeps the einsum: the
    flash kernel's entry is never called."""
    def refuse(*a, **k):
        raise AssertionError("the CPU chunk called flash_attention")

    monkeypatch.setattr(tg, "flash_attention", refuse)
    jcfg, tcfg, tree, params = _models(**kw)
    prompt = np.random.default_rng(0).integers(0, 97, size=(2, 7))
    want = jg.generate(tree, jnp.asarray(prompt, jnp.int32), jcfg, 12)
    got = tg.generate(params, prompt, tcfg, 12, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_chunk_forward_matches_full_forward():
    """Prefill then per-row decode (positions=) reproduces the full
    forward's logits at every position."""
    _, tcfg, _, params = _models(pos="rope")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97, (2, 9)))
    full = tt.forward(params, toks, tcfg, device="cpu")
    cache = tg.KVCache.empty(tcfg, 2, 16, device="cpu")
    logits, cache = tg._forward_chunk(params, toks[:, :5], cache, tcfg)
    assert cache.length == 5
    np.testing.assert_allclose(logits, full[:, :5], atol=1e-5)
    for t in range(5, 9):
        step, cache = tg._forward_chunk(
            params, toks[:, t:t + 1], cache, tcfg,
            positions=torch.tensor([t, t], dtype=torch.int32),
        )
        np.testing.assert_allclose(step[:, 0], full[:, t], atol=1e-5)
    assert cache.length == 5  # per-row mode leaves the length to the caller


@pytest.mark.parametrize(
    "kw", [dict(), dict(moe_experts=4, n_kv_heads=2, pos="rope")],
    ids=["mha-learned", "moe4-gqa-rope"],
)
def test_greedy_generate_int8_token_exact(kw):
    """int8 weights (JAX quantize_params, bridged as int8 leaves, and the
    port's own quantize_params of the float tree): greedy streams equal
    JAX's int8 stream, and the f32-side dequantized weights are JAX's."""
    jcfg, tcfg, tree, params = _models(**kw)
    qtree = jq.quantize_params(tree)
    prompt = np.random.default_rng(3).integers(0, 97, size=(2, 6))
    want = jg.generate(qtree, jnp.asarray(prompt, jnp.int32), jcfg, 10)
    for qparams in (params_from_jax(jax.device_get(qtree), tcfg,
                                    device="cpu"),
                    tq.quantize_params(params)):
        got = tg.generate(qparams, prompt, tcfg, 10, device="cpu")
        assert got.tolist() == np.asarray(want).tolist()


def test_moe_chunk_capacity_policy():
    """A MoE prefill chunk routes with the training factor (its logits
    are the forward's, drops included); moe_drop_free routes with factor
    E, capacity T: the forward of a config with that factor."""
    _, tcfg, _, params = _models(moe_experts=4, moe_capacity_factor=1.0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (2, 9)))
    for drop_free, factor in ((False, 1.0), (True, 4.0)):
        cache = tg.KVCache.empty(tcfg, 2, 16, device="cpu")
        logits, _ = tg._forward_chunk(params, toks, cache, tcfg,
                                      moe_drop_free=drop_free)
        cfg = tt.ModelConfig(**BASE, dtype=torch.float32, moe_experts=4,
                             moe_capacity_factor=factor)
        full = tt.forward(params, toks, cfg, device="cpu")
        np.testing.assert_allclose(logits, full, atol=1e-5)
    capped = tt.forward(params, toks, tcfg, device="cpu")
    assert (capped - full).abs().max() > 1e-3    # this batch drops tokens


def _gumbel_argmax_np(masked, u):
    return np.argmax(masked - np.log(-np.log(u)), axis=-1)


def test_sample_rowwise_injected_uniforms():
    """The masked logits the port samples from, rebuilt in numpy from
    the JAX algebra (temperature, per-row top-k, nucleus top-p), and the
    same uniforms give the same tokens; temperature 0 rows are argmax."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5, 40)).astype(np.float32) * 3
    temp = np.asarray([0.0, 1.0, 0.7, 1.3, 0.9], np.float32)
    top_k = np.asarray([0, 0, 5, 0, 3], np.int32)
    top_p = np.asarray([0.0, 0.0, 0.0, 0.6, 0.8], np.float32)
    u = rng.uniform(1e-6, 1.0, size=logits.shape).astype(np.float32)
    got = tg._sample_rowwise(
        torch.from_numpy(logits), None, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p),
        uniforms=torch.from_numpy(u),
    ).numpy()
    want = []
    for i in range(5):
        if temp[i] == 0:
            want.append(int(np.argmax(logits[i])))
            continue
        scaled = logits[i] / temp[i]
        order = np.sort(scaled)[::-1]
        k = top_k[i] or 40
        probs = np.exp(order[:k] - order[0])
        probs /= probs.sum()
        before = np.cumsum(probs) - probs
        p = top_p[i] if 0 < top_p[i] < 1 else 1.0
        cutoff = order[max(int(np.sum(before < p)), 1) - 1]
        masked = np.where(scaled >= cutoff, scaled, -1e30)
        want.append(int(_gumbel_argmax_np(masked[None], u[i][None])[0]))
    assert got.tolist() == want


@pytest.mark.parametrize(
    "temp,top_k,top_p", [(1.0, 0, 0.0), (0.8, 4, 0.0), (1.2, 0, 0.7)]
)
def test_sample_distribution_matches_jax(temp, top_k, top_p):
    """Same support and frequencies within sampling noise (4000 draws
    each: twice the 3-sigma binomial bound, plus 0.01)."""
    logits = np.linspace(2.0, -2.0, 12).astype(np.float32)[None]
    n = 4000
    lj = jnp.asarray(np.repeat(logits, n, axis=0))
    want = np.asarray(
        jg._sample(lj, jax.random.key(0), temp, top_k, top_p)
    )
    gen = torch.Generator().manual_seed(0)
    got = tg._sample(
        torch.from_numpy(np.repeat(logits, n, axis=0)), gen, temp, top_k,
        top_p,
    ).numpy()
    fw = np.bincount(want, minlength=12) / n
    fg = np.bincount(got, minlength=12) / n
    assert set(np.nonzero(fw)[0]) == set(np.nonzero(fg)[0])
    bound = 3 * np.sqrt(np.maximum(fw, 1e-3) * (1 - fw) / n) * 2 + 0.01
    assert (np.abs(fw - fg) <= bound).all(), (fw, fg)


def test_generate_guards():
    _, tcfg, _, params = _models()
    with pytest.raises(ValueError, match="max_seq"):
        tg.generate(params, [[1, 2]], tcfg, 200, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        tg.generate(params, [[1, 2]], tcfg, 2, device="meta")


# -- the prefill's self-attention rule -------------------------------------

BF16 = torch.bfloat16
# a chunk the flash kernel takes: 16 tokens from position 0 into a 16-slot
# bf16 cache, head_dim 128, on a CUDA device
ACCEPT = dict(t=16, length=0, width=16, cache_dtype=BF16, q_dtype=BF16,
              device="cuda", head_dim=128, positions=None, ring=None)


@pytest.mark.parametrize("change,takes", [
    (dict(), True),
    (dict(t=12), True),                       # a padded bucket's prompt
    (dict(head_dim=64), True),
    (dict(length=4), False),                  # a prefix tail
    (dict(positions=torch.tensor([0])), False),
    (dict(ring=(0, torch.arange(16))), False),
    (dict(cache_dtype=torch.int8), False),
    (dict(cache_dtype=torch.float32), False),  # f32 cache, bf16 q
    (dict(cache_dtype=torch.float32, q_dtype=torch.float32), False),
    (dict(head_dim=96), False),
    (dict(device="cpu"), False),
    (dict(t=32), False),                      # wider than the cache
], ids=["accepts", "accepts-short-chunk", "accepts-h64", "prefix-tail",
        "positions", "ring", "int8-cache", "f32-cache-bf16-q", "f32",
        "head-dim-96", "cpu", "chunk-past-cache"])
def test_chunk_self_attends_rule(change, takes):
    """The one rule that sends a chunk's attention to the flash kernel:
    from position 0, no per-row positions or ring, within the cache, a
    bf16 cache under bf16 q, on a CUDA device, in the kernel's gate. The
    device type and q's dtype are plain values, so no card is needed."""
    a = {**ACCEPT, **change}
    shape = (1, 1, a["width"], 2, a["head_dim"])
    cache = tg.KVCache(k=torch.zeros(shape, dtype=a["cache_dtype"]),
                       v=torch.zeros(shape, dtype=a["cache_dtype"]),
                       length=a["length"])
    got = tg._chunk_self_attends(a["t"], cache, a["q_dtype"], a["device"],
                                 a["head_dim"], a["positions"], a["ring"])
    assert got is takes
