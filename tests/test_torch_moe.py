"""The PyTorch port's Switch-MoE layer (elastic_tpu_agent_torch/workloads/
moe.py) and a MoE model against the JAX package on the same inputs (numpy,
from a seed), in float32 on the CPU.

Tolerances: 1e-5 (atol and rtol) for the layer's output, aux loss and
gradients, the frameworks' float32 summation-order bound for one layer;
1e-4 for whole-model logits, as the dense forward's test. Routing (which
expert, which slot, which tokens are dropped) must be identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import moe as jm  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import moe as tm  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    jax_layout_shapes,
    params_from_jax,
)

B, S, D, FF = 2, 16, 32, 48
MODEL = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=96, moe_experts=4)


def _layer(e, seed=0):
    """A JAX init_moe_params layer, scaled up so the router's softmax is
    far from uniform (routes are then decided by clear margins), with an
    input x and a cotangent r [B, S, D], as numpy."""
    params = jm.init_moe_params(jax.random.key(seed), D, FF, e)
    params = {k: np.asarray(v) * (40.0 if k == "wg" else 1.0)
              for k, v in params.items()}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    r = rng.normal(size=(B, S, D)).astype(np.float32)
    return params, x, r


def _tparams(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _jax_routing(x, wg, factor):
    """Expert, slot and kept mask as moe.py's one-hot bookkeeping
    (lines 163-186) computes them: the reference for the port's route()."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    e = wg.shape[1]
    cap = jm.expert_capacity(xt.shape[0], e, factor)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, wg), axis=-1)
    mask = jax.nn.one_hot(jnp.argmax(probs, -1), e, dtype=jnp.int32)
    position = jnp.cumsum(mask, axis=0) * mask
    mask = mask * (position <= cap)
    slot = jnp.sum((position - 1) * mask, axis=-1)
    return (np.asarray(jnp.argmax(probs, -1)), np.asarray(slot),
            np.asarray(mask.sum(-1) > 0))


@pytest.mark.parametrize("factor", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("experts", [1, 2, 4])
def test_moe_mlp_matches_jax(experts, factor):
    """y, aux and routing against the JAX layer; drops are included (at
    factor 1.0 and 1.25 some expert overflows for E > 1)."""
    params, x, _ = _layer(experts)
    jy, jaux = jm.moe_mlp(jnp.asarray(x), params, factor)
    y, aux = tm.moe_mlp(torch.from_numpy(x), _tparams(params), factor)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _, expert, slot, kept, _ = tm.route(
        torch.from_numpy(x).reshape(-1, D), _tparams(params)["wg"], factor)
    want = _jax_routing(x, params["wg"], factor)
    np.testing.assert_array_equal(expert.numpy(), want[0])
    np.testing.assert_array_equal(slot.numpy(), want[1])
    np.testing.assert_array_equal(kept.numpy(), want[2])
    # a dropped token's output is exactly 0 on both sides
    dropped = ~kept.numpy()
    assert not y.reshape(-1, D).numpy()[dropped].any()
    assert not np.asarray(jy).reshape(-1, D)[dropped].any()
    if experts > 1 and factor < 4.0:
        assert dropped.any()
    if factor == 4.0:
        assert not dropped.any()


@pytest.mark.parametrize("factor", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("experts", [1, 2, 4])
def test_moe_mlp_grads_match_jax(experts, factor):
    """Gradients of sum(y * r) + aux with respect to x, wg, w1 and w2."""
    params, x, r = _layer(experts, seed=1)

    def jobj(x, p):
        y, aux = jm.moe_mlp(x, p, factor)
        return jnp.sum(y * r) + aux

    jgx, jgp = jax.grad(jobj, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    xs = torch.from_numpy(x).requires_grad_()
    ps = {k: v.requires_grad_() for k, v in _tparams(params).items()}
    y, aux = tm.moe_mlp(xs, ps, factor)
    obj = (y * torch.from_numpy(r)).sum() + aux
    got = torch.autograd.grad(obj, [xs] + [ps[k] for k in ("wg", "w1", "w2")])
    want = [jgx] + [jgp[k] for k in ("wg", "w1", "w2")]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_one_expert_is_the_dense_mlp():
    """E = 1: every token goes to the one expert with gate 1.0 and the
    capacity holds them all, so the layer is the dense MLP with that
    expert's weights (1e-6: bmm and einsum may sum in other orders)."""
    params, x, _ = _layer(1, seed=2)
    y, aux = tm.moe_mlp(torch.from_numpy(x), _tparams(params), 1.0)
    cfg = tt.ModelConfig(**dict(MODEL, moe_experts=0), dtype=torch.float32)
    dense = tt._mlp(torch.from_numpy(x), {
        "w1": torch.from_numpy(params["w1"][0]),
        "w2": torch.from_numpy(params["w2"][0]),
    }, cfg)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=1e-6, rtol=0)
    assert float(aux) == 1.0


def test_expert_capacity_grid():
    for n in (1, 7, 16, 32, 1000, 2048):
        for e in (1, 2, 3, 4, 8):
            for f in (0.1, 1.0, 1.25, 2.0, 4.0):
                assert tm.expert_capacity(n, e, f) == jm.expert_capacity(
                    n, e, f), (n, e, f)


def test_routing_stats_match_jax():
    """The same batches through both ledgers give equal dicts."""
    j, t = jm.MoeRoutingStats(), tm.MoeRoutingStats()
    assert t.stats() == j.stats()
    for seed, factor in ((0, 1.0), (1, 1.25), (2, 4.0)):
        params, x, _ = _layer(4, seed)
        aux = float(jm.moe_mlp(jnp.asarray(x), params, factor)[1])
        j.observe(x, params, factor, aux_loss=aux)
        t.observe(torch.from_numpy(x), _tparams(params), factor,
                  aux_loss=aux)
        t.observe(x.reshape(-1, D), params, factor)      # numpy, [t, d]
        j.observe(x.reshape(-1, D), params, factor)
    assert t.stats() == j.stats()
    assert t.stats()["dropped_tokens"] > 0


def test_init_moe_params_shapes():
    p = tm.init_moe_params(torch.Generator().manual_seed(0), D, FF, 4,
                           device="cpu")
    want = jm.init_moe_params(jax.random.key(0), D, FF, 4)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in p.values())


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_moe_model_forward_matches_jax(pos):
    """A MoE model (layer 1 of 2 is MoE, 4 experts): logits and the
    summed aux loss against the JAX forward."""
    jcfg = jt.ModelConfig(**MODEL, dtype=jnp.float32, attn="reference",
                          pos=pos)
    tcfg = tt.ModelConfig(**MODEL, dtype=torch.float32, pos=pos)
    tree = jt.init_params(jcfg, jax.random.key(4))
    assert jax.tree_util.tree_map(
        lambda a: tuple(a.shape), tree) == jax_layout_shapes(tcfg)
    tokens = np.random.default_rng(6).integers(0, 97, size=(2, 24))
    jl, jaux = jt.forward_with_aux(tree, jnp.asarray(tokens, jnp.int32), jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    assert set(params["layers"][1]["moe"]) == {"wg", "w1", "w2"}
    for remat in (False, True):
        cfg = tt.ModelConfig(**MODEL, dtype=torch.float32, pos=pos,
                             remat=remat)
        with torch.enable_grad():
            logits, aux = tt.forward_with_aux(params, tokens, cfg,
                                              device="cpu")
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
