"""The PyTorch port's training slice against the JAX package on the same
inputs (numpy, from a seed), on the CPU: the flash backward, the
single-device train step with its options, and the eval loss.

Tolerances, all float32 unless stated:
- flash backward (dq, dk, dv): 1e-5 atol and rtol. Both sides compute the
  same products in f32 and differ in summation order only.
- step-0 gradients: 1e-5 of each leaf's largest gradient, the same
  summation-order bound carried through two layers and the loss.
- losses: 1e-5 relative (three steps of the bound above).
- params after three AdamW steps: 1e-5 absolute, except where Adam's
  first update g/|g| turns on the sign of a gradient that is rounding
  noise: there the two frameworks may move an element by up to lr per
  step in opposite directions. Such elements are bounded explicitly: at
  most 1e-4 of a tree's elements, each within 2 * lr * steps + 1e-5.
- master_weights at bfloat16: both frameworks compute the forward in
  bf16 but round at other places (matmul accumulation, the fused ops), so
  each gradient is known to about 1% only. Losses agree to 1e-3 (7.3e-5
  measured). Masters agree to 1e-4 except the elements whose gradient is
  within that noise of zero, which Adam moves by up to lr per step
  either way: at most 2% of them (1.2% measured), each within
  2 * lr * steps + 1e-4.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from elastic_tpu_agent.workloads import attention as ja  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import attention as ta  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)

LR = 1e-3
STEPS = 3
BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)
# head_dim 128: the TPU flash gate, so JAX runs its interpret-mode kernels
FLASH = dict(vocab=64, d_model=256, n_heads=2, n_layers=2, d_ff=128,
             max_seq=256)


def _np(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        atol=tol, rtol=tol,
    )


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


# -- flash backward -------------------------------------------------------


def _torch_grads(fn, arrays, cotangents):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    obj = sum((o * torch.from_numpy(w)).sum()
              for o, w in zip(outs, cotangents))
    grads = torch.autograd.grad(obj, xs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, xs)]


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize(
    "causal,window", [(True, 0), (False, 0), (True, 96)],
    ids=["causal", "noncausal", "window"],
)
def test_plain_flash_bwd_matches_pallas_interpret(causal, window, with_lse):
    """jax.grad of sum(o * w) (+ sum(lse * wl)) through the Pallas
    backward in interpret mode against the port's autograd, which on the
    CPU runs the kernels' plain versions (head_dim 128: the TPU gate)."""
    rng = np.random.default_rng(10)
    s = 256
    q, k, v, w = (_np(rng, 1, s, 2, 128) for _ in range(4))
    wl = _np(rng, 1, 2, s)
    jcfg = ja.FlashConfig(causal=causal, block_q=128, block_k=128,
                          interpret=True, window=window)
    tcfg = ta.FlashConfig(causal=causal, window=window)
    if with_lse:
        def jobj(q, k, v):
            o, lse = ja.flash_attention_with_lse(q, k, v, jcfg)
            return jnp.sum(o * w) + jnp.sum(lse * wl)
        want = jax.grad(jobj, argnums=(0, 1, 2))(q, k, v)
        got = _torch_grads(
            lambda q, k, v: ta.flash_attention_with_lse(q, k, v, tcfg),
            (q, k, v), (w, wl),
        )
    else:
        want = jax.grad(
            lambda q, k, v: jnp.sum(ja.flash_attention(q, k, v, jcfg) * w),
            argnums=(0, 1, 2),
        )(q, k, v)
        got = _torch_grads(
            lambda q, k, v: ta.flash_attention(q, k, v, tcfg), (q, k, v), (w,)
        )
    for g, wnt in zip(got, want):
        _close(g, wnt)


@pytest.mark.parametrize(
    "causal,window", [(True, 0), (True, 37), (False, 0)],
    ids=["causal", "window37", "noncausal"],
)
def test_flash_grad_matches_reference_attention(causal, window):
    """Shapes the TPU gate never admits: GQA (2 kv heads of 4), ragged s
    200, head_dim 64; against autograd through reference_attention."""
    rng = np.random.default_rng(11)
    q, w = _np(rng, 2, 200, 4, 64), _np(rng, 2, 200, 4, 64)
    k, v = _np(rng, 2, 200, 2, 64), _np(rng, 2, 200, 2, 64)
    cfg = ta.FlashConfig(causal=causal, window=window)
    got = _torch_grads(
        lambda q, k, v: ta.flash_attention(q, k, v, cfg), (q, k, v), (w,)
    )
    want = _torch_grads(
        lambda q, k, v: ta.reference_attention(
            q, k, v, causal=causal, window=window),
        (q, k, v), (w,),
    )
    assert got[1].shape == (2, 200, 2, 64)
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_flash_lse_cotangent_alone():
    """Only lse is used downstream: the backward takes dO = 0 and the lse
    cotangent, whose gradient is d lse / d s = p."""
    rng = np.random.default_rng(12)
    q, k, v = (_np(rng, 1, 70, 2, 64) for _ in range(3))
    wl = _np(rng, 1, 2, 70)
    cfg = ta.FlashConfig()
    got = _torch_grads(
        lambda q, k, v: ta.flash_attention_with_lse(q, k, v, cfg)[1],
        (q, k, v), (wl,),
    )

    def lse_ref(q, k, v):
        scores = torch.einsum("bsnh,btnh->bnst", q, k) / 8.0
        mask = torch.ones(70, 70, dtype=torch.bool).tril()
        return torch.logsumexp(scores.masked_fill(~mask, -torch.inf), -1)

    want = _torch_grads(lse_ref, (q, k, v), (wl,))
    assert not got[2].abs().max()        # v does not reach lse
    for g, wnt in zip(got, want):
        _close(g, wnt)


# -- train step -----------------------------------------------------------


def _jax_loss(jcfg):
    def loss(params, tokens):
        logits, aux = jt.forward_with_aux(params, tokens[:, :-1], jcfg)
        nll = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), tokens[:, 1:]
        )
        return jnp.mean(nll) + jcfg.moe_aux_coef * aux
    return loss


def _setup(base, kw, jattn, dtype=jnp.float32, **opts):
    """JAX train step and its init_all params, and the port's train step
    with the same params bridged at the JAX step's storage dtype."""
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    jcfg = jt.ModelConfig(**base, dtype=dtype, attn=jattn, **kw)
    tcfg = tt.ModelConfig(**base, dtype=tdtype, **kw)
    mesh = jt.make_mesh(1, dp=1, sp=1, tp=1)
    jstep, jinit, _ = jt.make_train_step(jcfg, mesh, learning_rate=LR, **opts)
    jparams, jopt = jinit(jax.random.key(0))
    tree = jax.device_get(jparams)
    storage = tdtype if opts.get("master_weights") else torch.float32
    tparams = params_from_jax(tree, tcfg, device="cpu", dtype=storage)
    tstep, _, topt = tt.make_train_step(
        tcfg, learning_rate=LR, device="cpu", **opts
    )
    return (jcfg, jstep, jparams, jopt), (tcfg, tstep, tparams,
                                          topt.init(tparams))


def _run(j, t, tokens, steps=STEPS):
    _, jstep, jparams, jopt = j
    _, tstep, tparams, topt = t
    jl, tl = [], []
    for _ in range(steps):
        jparams, jopt, loss = jstep(jparams, jopt, jnp.asarray(tokens))
        jl.append(float(loss))
        tparams, topt, loss = tstep(tparams, topt, tokens)
        tl.append(float(loss))
    return (jparams, jopt, np.array(jl)), (tparams, topt, np.array(tl))


def _assert_params_close(got, want, steps=STEPS, tol=1e-5, frac=1e-4):
    """Every element within tol, but for Adam's sign-of-noise elements:
    at most ``frac`` of them, each within 2 * lr * steps + tol."""
    got, want = _leaves(got), _leaves(want)
    assert [g.shape for g in got] == [w.shape for w in want]
    diff = [np.abs(g - w) for g, w in zip(got, want)]
    total = sum(d.size for d in diff)
    off = sum(int((d > tol).sum()) for d in diff)
    assert off <= frac * total, f"{off} of {total} elements off by > {tol}"
    worst = max(float(d.max()) for d in diff)
    assert worst <= 2 * LR * steps + tol, worst


def _tokens(vocab, seq, *lead, seed=7):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(*lead, seq + 1)
    ).astype(np.int32)


@pytest.mark.parametrize(
    "base,kw,jattn,seq",
    [
        (BASE, {}, "reference", 20),
        (BASE, dict(pos="rope", n_kv_heads=2, window=5), "reference", 20),
        (FLASH, {}, "flash", 128),
    ],
    ids=["mha-learned", "gqa-rope-window", "flash-h128"],
)
def test_train_step_matches_jax(base, kw, jattn, seq):
    j, t = _setup(base, kw, jattn)
    tokens = _tokens(base["vocab"], seq, 2)
    want = jax.grad(_jax_loss(j[0]))(j[2], jnp.asarray(tokens))
    _, got = tt.loss_and_grads(t[2], tokens, t[0], device="cpu")
    for g, w in zip(_leaves(params_to_jax(got)), _leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)
    (jp, _, jl), (tp, topt, tl) = _run(j, t, tokens)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params_close(params_to_jax(tp), jax.device_get(jp))
    assert int(topt["count"]) == STEPS


def test_accum_steps_matches_jax():
    j, t = _setup(BASE, {}, "reference", accum_steps=2)
    tokens = _tokens(BASE["vocab"], 20, 2, 2)
    (jp, _, jl), (tp, _, tl) = _run(j, t, tokens)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params_close(params_to_jax(tp), jax.device_get(jp))
    with pytest.raises(ValueError, match="accum_steps"):
        t[1](tp, t[3], tokens[0])


MOE = dict(moe_experts=4, pos="rope")


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_moe_train_step_matches_jax(accum):
    """A MoE model (4 experts in layer 1, aux coefficient 0.01): step-0
    gradients, then 5 steps' losses and params against the JAX step. With
    accum_steps 2 each micro-batch routes and caps on its own, on both
    sides."""
    j, t = _setup(BASE, MOE, "reference", accum_steps=accum)
    lead = (accum, 2) if accum > 1 else (2,)
    tokens = _tokens(BASE["vocab"], 20, *lead)
    if accum == 1:
        want = jax.grad(_jax_loss(j[0]))(j[2], jnp.asarray(tokens))
        loss, got = tt.loss_and_grads(t[2], tokens, t[0], device="cpu")
        for g, w in zip(_leaves(params_to_jax(got)), _leaves(want)):
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(),
                                       rtol=0)
        logits, aux = tt.forward_with_aux(t[2], tokens[:, :-1], t[0], "cpu")
        assert float(aux) > 0.0
        nll = tt._nll(logits, torch.from_numpy(tokens[:, 1:]).long())
        assert float(loss) == pytest.approx(
            float(nll) + 0.01 * float(aux), rel=1e-6)
    (jp, _, jl), (tp, _, tl) = _run(j, t, tokens, steps=5)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params_close(params_to_jax(tp), jax.device_get(jp), steps=5)


def test_ema_matches_jax():
    j, t = _setup(BASE, {}, "reference", ema_decay=0.9)
    tokens = _tokens(BASE["vocab"], 20, 2)
    (_, jopt, _), (_, topt, _) = _run(j, t, tokens)
    ema = tt.ema_params(topt)
    _assert_params_close(params_to_jax(ema), jt.ema_params(jopt))
    assert tt.ema_params(tt.AdamW().init(t[2])) is None
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="ema_decay"):
            tt.make_train_step(t[0], ema_decay=bad, device="cpu")


def test_master_weights_bf16_matches_jax():
    j, t = _setup(BASE, {}, "reference", dtype=jnp.bfloat16,
                  master_weights=True)
    tokens = _tokens(BASE["vocab"], 20, 2)
    (jp, jopt, jl), (tp, topt, tl) = _run(j, t, tokens)
    assert all(x.dtype == torch.bfloat16 for x in tt._leaves(tp))
    masters = tt._leaves(topt["masters"])
    assert all(x.dtype == torch.float32 for x in masters)
    # live leaves are the masters re-rounded
    for live, m in zip(tt._leaves(tp), masters):
        assert torch.equal(live, m.to(torch.bfloat16))
    np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    assert tl[-1] < tl[0]
    _assert_params_close(params_to_jax(topt["masters"]), jopt[1], tol=1e-4,
                         frac=2e-2)


def test_eval_fn_matches_jax():
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference",
                          n_kv_heads=2)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, n_kv_heads=2)
    tree = jt.init_params(jcfg, jax.random.key(3))
    tokens = _tokens(BASE["vocab"], 30, 3)
    want = jt.make_eval_fn(jcfg, jt.make_mesh(1, dp=1, sp=1, tp=1))(
        tree, jnp.asarray(tokens))
    params = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    got = tt.make_eval_fn(tcfg, device="cpu")(params, tokens)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_remat_gives_the_same_gradients():
    """remat recomputes each layer, the flash op's forward included
    (head_dim 64 takes the flash path), in the backward."""
    base = dict(BASE, d_model=128, n_heads=2)
    tcfg = tt.ModelConfig(**base, dtype=torch.float32, pos="rope")
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens(BASE["vocab"], 24, 2)
    loss, grads = tt.loss_and_grads(params, tokens, tcfg, device="cpu")
    rcfg = tt.ModelConfig(**base, dtype=torch.float32, pos="rope",
                          remat=True)
    rloss, rgrads = tt.loss_and_grads(params, tokens, rcfg, device="cpu")
    assert float(rloss) == float(loss)
    for a, b in zip(tt._leaves(rgrads), tt._leaves(grads)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_init_all_and_schedule():
    """init_all stores f32 (cfg.dtype live leaves under master_weights); a
    callable learning rate is read at the pre-increment count, as optax's
    scale_by_schedule reads it."""
    cfg = tt.ModelConfig(**BASE, dtype=torch.bfloat16)
    seen = []
    step, init_all, opt = tt.make_train_step(
        cfg, learning_rate=lambda c: seen.append(c) or 1e-3, device="cpu")
    params, state = init_all(torch.Generator().manual_seed(1))
    assert all(x.dtype == torch.float32 for x in tt._leaves(params))
    assert not any(x.requires_grad for x in tt._leaves(params))
    tokens = _tokens(BASE["vocab"], 16, 2)
    for _ in range(2):
        params, state, loss = step(params, state, tokens)
    assert seen == [0, 1] and loss.dtype == torch.float32
    _, init_m, _ = tt.make_train_step(cfg, master_weights=True, device="cpu")
    live, mstate = init_m(torch.Generator().manual_seed(1))
    assert all(x.dtype == torch.bfloat16 for x in tt._leaves(live))
    assert set(mstate) == {"count", "mu", "nu", "masters"}
    # zero1 without a mesh is a no-op, as in JAX: the plain step's numbers
    runs = []
    for z in (False, True):
        zstep, zinit, _ = tt.make_train_step(cfg, zero1=z, device="cpu")
        zparams, zstate = zinit(torch.Generator().manual_seed(1))
        runs.append(([float(zstep(zparams, zstate, tokens)[2])
                      for _ in range(2)], tt._leaves(zparams)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_workloads_package_exports_the_training_slice():
    w = importlib.import_module("elastic_tpu_agent_torch.workloads")
    for name in ("make_train_step", "make_eval_fn", "ema_params", "AdamW",
                 "loss_and_grads"):
        assert getattr(w, name) is getattr(tt, name)
