"""ZeRO-1 in the port's sharded train step against the JAX package's
``zero1`` on the same mesh, weights and tokens, on the CPU.

The port's side runs in one spawned gloo world of 4 ranks
(``torch_worlds.py``), every leg once, in a module fixture. Each
optimizer-state leaf (``mu``, ``nu``, the f32 masters, the EMA) is cut
over dp along the first axis that its param's split spec leaves free and
that dp divides (JAX's ``zero1_shard``); a rank updates its slice and the
fresh params are all-gathered over dp.

Tolerances (f32): losses against the unsharded run and JAX's 1e-5
relative (JAX's own bound for zero1, ``tests/test_mixed_precision.py``);
params as ``test_torch_mesh_train.py`` bounds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402

import torch_worlds  # noqa: E402
from test_torch_mesh_train import (  # noqa: E402
    CFG,
    LR,
    STEPS,
    VARIANTS,
    _assert_trees_close,
    _jax_tree,
    _tokens,
)

MASTER_EMA = dict(master_weights=True, ema_decay=0.9)
LEGS = {
    "base-4x1x1": ((4, 1, 1), MASTER_EMA, _tokens(4)),
    "zero1-4x1x1": ((4, 1, 1), dict(MASTER_EMA, zero1=True), _tokens(4)),
    "zero1-2x1x2": ((2, 1, 2), dict(MASTER_EMA, zero1=True), _tokens(4)),
    "accum-4x1x1": ((4, 1, 1), dict(accum_steps=2), _tokens(2, 4)),
    "zero1-accum-4x1x1": ((4, 1, 1), dict(accum_steps=2, zero1=True),
                          _tokens(2, 4)),
}
KW = VARIANTS["rope-gqa"]


@pytest.fixture(scope="module")
def world():
    spec = dict(lr=LR, steps=STEPS, legs=[
        dict(name=name, mesh=mesh, cfg=dict(CFG, **KW), tree=_jax_tree(KW),
             tokens=tokens, opts=opts)
        for name, (mesh, opts, tokens) in LEGS.items()
    ])
    return torch_worlds.run_world(torch_worlds.train_legs, 4, spec)


def _jax(name, run=True):
    mesh, opts, tokens = LEGS[name]
    jcfg = jt.ModelConfig(**CFG, **KW, dtype=jnp.float32)
    jmesh = jt.make_mesh(4, dp=mesh[0], sp=mesh[1], tp=mesh[2])
    step, init_all, _ = jt.make_train_step(jcfg, jmesh, learning_rate=LR,
                                           **opts)
    params, opt = init_all(jax.random.key(0))
    if not run:
        return opt
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(tokens))
        losses.append(float(loss))
    return np.array(losses), jax.device_get(params)


def _shard_shapes(tree):
    """{leaf path: the shape of the leaf's first addressable shard}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = tuple(leaf.addressable_shards[0].data.shape)
    return out


@pytest.mark.parametrize("name", ["zero1-4x1x1", "zero1-2x1x2"])
def test_zero1_shard_shapes_match_jax(world, name):
    """mu, nu, the masters and the EMA: each leaf's local shard shape on
    rank 0 is that of JAX's first addressable shard, leaf for leaf; the
    step count stays whole."""
    inner, masters = _jax(name, run=False)
    adam = [s for s in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    want = {"mu": adam.mu, "nu": adam.nu, "masters": masters,
            "ema": jt.ema_params(inner)}
    got = world[0][name]["state_shapes"]
    assert set(got) == set(want)
    cut = 0
    for key, tree in want.items():
        w = _shard_shapes(tree)
        assert got[key] == w, key
        cut += sum(s != tuple(x.shape) for s, x in zip(
            w.values(), jax.tree_util.tree_leaves(tree)))
    assert cut > 0
    assert adam.count.shape == ()


def test_zero1_losses_equal_the_unsharded_run(world):
    """The same master-weights + EMA run with and without zero1 at dp 4:
    losses within 1e-5 relative, params and EMA alike, and both JAX's."""
    base, z = world[0]["base-4x1x1"], world[0]["zero1-4x1x1"]
    np.testing.assert_allclose(z["losses"], base["losses"], rtol=1e-5)
    _assert_trees_close(z["params"], base["params"])
    _assert_trees_close(z["ema"], base["ema"])
    jl, jp = _jax("zero1-4x1x1")
    np.testing.assert_allclose(z["losses"], jl, rtol=1e-5)
    _assert_trees_close(z["params"], jp)
    for r in range(1, 4):
        assert world[r]["zero1-4x1x1"]["losses"] == z["losses"]


def test_zero1_with_tensor_parallel_matches_jax(world):
    """dp 2 x tp 2: zero1 cuts each tp shard's state over dp, on an axis
    other than 0 where the spec splits axis 0 (wo, w2)."""
    jl, jp = _jax("zero1-2x1x2")
    res = world[0]["zero1-2x1x2"]
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-5)
    _assert_trees_close(res["params"], jp)
    shapes = res["state_shapes"]["mu"]
    assert shapes["layers/0/w2"] == (64, 32)      # tp on 0, dp on 1
    assert shapes["layers/0/wo"] == (2, 8, 64)


def test_zero1_with_accumulation(world):
    """zero1 with accum_steps 2 equals the unsharded accumulation and
    JAX's zero1 accumulation."""
    z, base = world[0]["zero1-accum-4x1x1"], world[0]["accum-4x1x1"]
    np.testing.assert_allclose(z["losses"], base["losses"], rtol=1e-5)
    _assert_trees_close(z["params"], base["params"])
    jl, jp = _jax("zero1-accum-4x1x1")
    np.testing.assert_allclose(z["losses"], jl, rtol=1e-5)
    _assert_trees_close(z["params"], jp)
