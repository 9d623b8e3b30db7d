"""The PyTorch port's model pieces and flagship forward against the JAX
package on the same inputs (numpy, from a seed), in float32 on the CPU.

Tolerances: 1e-5 for single ops and 1e-4 (atol and rtol) for whole-model
logits. Both are float32 summation-order bounds: the two frameworks
reduce einsums and softmaxes in different orders."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import attention as ja  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import attention as ta  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)


def _pair(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, 2, 7, 3, 16)
    pos = (
        rng.integers(0, 500, size=(2, 7)) if per_row
        else np.arange(5, 12)
    ).astype(np.int32)
    _close(
        tt.rope(xt, torch.from_numpy(pos), 500.0),
        jt.rope(xj, jnp.asarray(pos), 500.0),
    )


def test_rmsnorm_and_mlp():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, 2, 5, 32)
    sj, st = _pair(rng, 32)
    _close(tt._rmsnorm(xt, st), jt._rmsnorm(xj, sj))
    w1j, w1t = _pair(rng, 32, 64)
    w2j, w2t = _pair(rng, 64, 32)
    jcfg = jt.ModelConfig(d_model=32, d_ff=64, dtype=jnp.float32)
    tcfg = tt.ModelConfig(d_model=32, d_ff=64, dtype=torch.float32)
    _close(
        tt._mlp(xt, {"w1": w1t, "w2": w2t}, tcfg),
        jt._mlp(xj, {"w1": w1j, "w2": w2j}, jcfg),
        tol=1e-4,
    )


@pytest.mark.parametrize(
    "causal,window", [(True, 0), (False, 0), (True, 5)]
)
def test_reference_attention(causal, window):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, 2, 12, 4, 8)
    kj, kt = _pair(rng, 2, 12, 4, 8)
    vj, vt = _pair(rng, 2, 12, 4, 8)
    _close(
        ta.reference_attention(qt, kt, vt, causal=causal, window=window),
        ja.reference_attention(qj, kj, vj, causal=causal, window=window),
    )


@pytest.mark.parametrize(
    "s,causal,window", [(256, True, 0), (128, False, 0), (256, True, 96)],
    ids=["causal", "noncausal", "window"],
)
def test_plain_flash_matches_pallas_interpret(s, causal, window):
    """o and lse of the kernel's plain version against the TPU kernel
    run in interpret mode (head_dim 128: the TPU gate)."""
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, 1, s, 2, 128)
    kj, kt = _pair(rng, 1, s, 2, 128)
    vj, vt = _pair(rng, 1, s, 2, 128)
    jcfg = ja.FlashConfig(
        causal=causal, block_q=128, block_k=128, interpret=True,
        window=window,
    )
    o_j, lse_j = ja.flash_attention_with_lse(qj, kj, vj, jcfg)
    tcfg = ta.FlashConfig(causal=causal, window=window)
    with torch.no_grad():
        o_t, lse_t = ta.flash_attention_with_lse(qt, kt, vt, tcfg)
    assert o_t.shape == (1, s, 2, 128) and lse_t.shape == (1, 2, s)
    _close(o_t, o_j, tol=1e-5)
    _close(lse_t, lse_j, tol=1e-5)


def test_flash_gate_and_forward_only():
    assert ta.supports_flash(200, 64)       # ragged tile, head_dim 64
    assert ta.supports_flash(256, 128)
    assert not ta.supports_flash(256, 32)
    assert not ta.supports_flash(256, 96)
    # the tile is the kernel's, not an option that could divert a call
    assert not hasattr(ta.FlashConfig(), "block_q")
    q = torch.zeros((1, 8, 1, 32))
    # outside the gate: flash_attention falls back, the lse form refuses
    assert ta.flash_attention(q, q, q).shape == q.shape
    with pytest.raises(ValueError, match="gate"):
        ta.flash_attention_with_lse(q, q, q)
    # inside the gate the op is differentiable: the gradient flows through
    # the backward's plain versions and matches the reference path's
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 8, 1, 64)).astype(np.float32))
    x.requires_grad_()
    (g_flash,) = torch.autograd.grad(ta.flash_attention(x, x, x).sum(), x)
    (g_ref,) = torch.autograd.grad(
        ta.reference_attention(x, x, x).sum(), x
    )
    _close(g_flash, g_ref)


def test_tma_alignment_gate():
    """The bf16 kernels read [b, s, heads, h] inputs by TMA: 16-byte
    aligned bases and b/s/head strides, checked before a launch; float32
    takes any strides. The autograd backward copies a dO that fails the
    check (on the CPU, where the plain versions run, the result is the
    same either way)."""
    bf = torch.bfloat16
    x = torch.zeros((2, 8, 4, 64), dtype=bf)
    fused = torch.zeros((2, 8, 3, 4, 64), dtype=bf)[:, :, 1]
    padded = torch.zeros((2, 8, 4, 68), dtype=bf)[..., :64]   # 136-byte head
    shifted = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=bf)[1:].view(2, 8, 4, 64)
    assert ta._tma_aligned(x) and ta._tma_aligned(fused)
    assert not ta._tma_aligned(padded) and not ta._tma_aligned(shifted)
    ta._check_tma(x, fused)
    for bad in (padded, shifted):
        with pytest.raises(ValueError, match="TMA"):
            ta._check_tma(x, bad)
    ta._check_tma(padded.float(), torch.zeros((2, 8, 4, 68))[..., :64])

    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=(1, 8, 2, 64)), dtype=bf,
                            requires_grad=True) for _ in range(3))
    do = torch.tensor(rng.normal(size=(1, 8, 2, 64)), dtype=bf)
    do_pad = torch.zeros((1, 8, 2, 68), dtype=bf)
    do_pad[..., :64] = do
    got = torch.autograd.grad(ta.flash_attention(q, k, v), (q, k, v),
                              do_pad[..., :64])
    want = torch.autograd.grad(ta.flash_attention(q, k, v), (q, k, v), do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(n_kv_heads=2),
        dict(pos="rope"),
        dict(pos="rope", n_kv_heads=2, window=5),
        dict(window=7),
    ],
    ids=["mha-learned", "gqa", "rope", "rope-gqa-window", "window"],
)
def test_forward_logits_match_jax(kw):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, **kw)
    tree = jt.init_params(jcfg, jax.random.key(0))
    params = params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, 97, size=(3, 20))
    want = jt.forward(tree, jnp.asarray(tokens, jnp.int32), jcfg)
    got = tt.forward(params, tokens, tcfg, device="cpu")
    assert got.shape == (3, 20, 97)
    assert got.grad_fn is None      # bridged params: autograd records nothing
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4
    )


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=1, window=40)])
def test_forward_flash_path_matches_jax_flash(kw):
    """attn='flash' on both sides at head_dim 128 (d 256, 2 heads): the
    JAX model runs the Pallas kernel in interpret mode, the port the
    flash kernel's plain version; the port's auto dispatch takes the
    same path."""
    base = dict(
        vocab=64, d_model=256, n_heads=2, n_layers=2, d_ff=128, max_seq=256
    )
    jcfg = jt.ModelConfig(**base, dtype=jnp.float32, attn="flash", **kw)
    tree = jt.init_params(jcfg, jax.random.key(1))
    tokens = np.random.default_rng(5).integers(0, 64, size=(1, 128))
    want = np.asarray(jt.forward(tree, jnp.asarray(tokens, jnp.int32), jcfg))
    for attn in ("flash", "auto"):
        tcfg = tt.ModelConfig(**base, dtype=torch.float32, attn=attn, **kw)
        params = params_from_jax(tree, tcfg, device="cpu")
        got = tt.forward(params, tokens, tcfg, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_later_slices_raise():
    """attn="ring" is accepted since the ring slice, and MoE over a mesh
    since the expert-parallel slice (ROADMAP item 4c): the step no longer
    refuses it, and checks only that ep splits the experts evenly."""
    assert tt.ModelConfig(attn="ring").attn == "ring"
    mesh = types.SimpleNamespace(device_type="cpu", size=lambda: 4,
                                 shape=(1, 1, 1, 4),
                                 mesh_dim_names=("dp", "sp", "tp", "ep"))
    with pytest.raises(ValueError, match="moe_experts 2 must split over "
                       "ep=4"):
        tt.make_train_step(tt.ModelConfig(moe_experts=2), device="cpu",
                           mesh=mesh)
