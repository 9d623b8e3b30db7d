"""The port's MoE layer under a dp/sp/tp/ep mesh against the JAX
package's on the same mesh, weights and tokens, on the CPU.

The JAX step runs in this process over the host devices; the port's runs
SPMD in one spawned gloo world of 4 ranks (``torch_worlds.py``), which
runs every leg of this file once, in a module fixture. The config is
``dryrun_multichip``'s MoE leg (vocab 512, d 64, 4 heads, 2 layers, ff
128, max_seq 64, 4 experts in the second layer) at f32. Routing is global
in both: the capacity, the slot order and the aux loss are those of the
whole batch, which the drop case (capacity factor 0.5 over dp 2) pins
down where routing each rank's tokens alone would keep other tokens.

Tolerances (f32): losses 1e-5 relative over 3 steps; the aux loss 1e-5
relative; gathered params as ``test_torch_mesh_train.py`` bounds them
(1e-5 absolute, but for Adam's sign-of-noise elements); routes and kept
sets exactly.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from elastic_tpu_agent.workloads import moe as jm  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import parallel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

import torch_worlds  # noqa: E402
from test_torch_mesh_train import _assert_trees_close, _ranks_agree  # noqa: E402

LR = 1e-3
STEPS = 3
CFG = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=64, moe_experts=4)
MESHES = [(1, 1, 2, 2), (2, 1, 1, 2), (1, 2, 1, 2)]
DROP = dict(moe_capacity_factor=0.5)


def _tokens(*lead, seed=7):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=(*lead, 33)).astype(np.int32)


def _mesh_id(mesh):
    return "x".join(map(str, mesh))


_TREE = []


def _jax_tree():
    if not _TREE:
        jcfg = jt.ModelConfig(**CFG, dtype=jnp.float32)
        _TREE.append(jax.device_get(jt.init_params(jcfg, jax.random.key(0))))
    return _TREE[0]


LEGS = [
    dict(name=_mesh_id(m), mesh=m, kw={}, tokens=_tokens(4), probe=True)
    for m in MESHES
] + [
    dict(name="accum2", mesh=(2, 1, 1, 2), kw={}, tokens=_tokens(2, 4),
         opts=dict(accum_steps=2)),
    dict(name="drop", mesh=(2, 1, 1, 2), kw=DROP, tokens=_tokens(4, seed=3),
         probe=True),
    dict(name="eval", mesh=(1, 2, 1, 2), kw={}, tokens=_tokens(4, seed=9),
         eval=True),
]
BY_NAME = {leg["name"]: leg for leg in LEGS}


@pytest.fixture(scope="module")
def world():
    spec = dict(lr=LR, steps=STEPS, legs=[
        dict(name=leg["name"], mesh=leg["mesh"], cfg=dict(CFG, **leg["kw"]),
             tree=_jax_tree(), tokens=leg["tokens"],
             opts=leg.get("opts", {}), eval=leg.get("eval", False),
             probe=leg.get("probe", False))
        for leg in LEGS
    ])
    return torch_worlds.run_world(torch_worlds.train_legs, 4, spec)


def _jax_mesh(mesh):
    dp, sp, tp, ep = mesh
    return jt.make_mesh(4, dp=dp, sp=sp, tp=tp, ep=ep)


def _jax_run(leg):
    jcfg = jt.ModelConfig(**CFG, **leg["kw"], dtype=jnp.float32)
    mesh = _jax_mesh(leg["mesh"])
    step, init_all, _ = jt.make_train_step(
        jcfg, mesh, learning_rate=LR, **leg.get("opts", {}))
    params, opt = init_all(jax.random.key(0))
    aux = None
    if leg.get("probe"):
        aux = float(jax.jit(lambda p, t: jt.forward_with_aux(
            p, t[:, :-1], jcfg, activation_sharding=NamedSharding(
                mesh, P("dp", "sp", None)))[1])(params, jnp.asarray(
                    leg["tokens"])))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(leg["tokens"]))
        losses.append(float(loss))
    return np.array(losses), jax.device_get(params), aux


class _FakeMesh:
    """The coordinates of one rank of a (dp, sp, tp, ep) mesh, as
    ``shard_params`` reads them."""

    def __init__(self, shape, rank):
        self.shape = shape
        self.mesh_dim_names = parallel.MESH_AXES
        self.coord = np.unravel_index(rank, shape)

    def get_local_rank(self, name):
        return int(self.coord[parallel.MESH_AXES.index(name)])


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_moe_specs_and_shards_match_jax(mesh):
    """Every leaf's split spec is JAX's (``moe_param_shardings`` for the
    MoE layer), and each rank's ``shard_params`` slice equals the JAX
    shard on the device of the same mesh coordinate, value for value."""
    jcfg = jt.ModelConfig(**CFG, dtype=jnp.float32)
    tcfg = tt.ModelConfig(**CFG, dtype=torch.float32)
    jmesh = _jax_mesh(mesh)
    jspecs = jt._full_param_shardings(jmesh, jcfg)
    tree = _jax_tree()
    placed = jax.device_put(tree, jspecs)
    full = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    specs = parallel.full_param_shardings(_FakeMesh(mesh, 0), tcfg)
    assert specs["layers"][1]["moe"] == {
        "wg": (), "w1": ("ep", None, "tp"), "w2": ("ep", "tp", None)}
    devices = list(jmesh.devices.flat)
    for rank in range(4):
        local = parallel.shard_params(full, _FakeMesh(mesh, rank), tcfg)

        def same(path, t):
            leaf, spec = placed, jspecs
            for p in path:
                leaf, spec = leaf[p], spec[p]
            pad = (None,) * t.dim()
            want_spec = (tuple(spec.spec) + pad)[:t.dim()]
            assert (parallel._spec_at(specs, path) + pad)[:t.dim()] \
                == want_spec, path
            shard = next(s for s in leaf.addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data),
                                          err_msg=str(path))

        tt._tree_map(same, local)


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_sharded_moe_step_matches_jax(world, mesh):
    """3 steps on each (dp, sp, tp, ep) mesh: losses, the aux loss at the
    first params and the gathered params equal JAX's; every rank agrees."""
    name = _mesh_id(mesh)
    jl, jp, jaux = _jax_run(BY_NAME[name])
    for r in range(4):
        np.testing.assert_allclose(world[r][name]["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(world[r][name]["aux"], jaux, rtol=1e-5)
    _assert_trees_close(world[0][name]["params"], jp)
    _ranks_agree(world, name)


def test_moe_accum_steps_matches_jax(world):
    """accum_steps 2: each micro-batch routed globally on its own."""
    jl, jp, _ = _jax_run(BY_NAME["accum2"])
    np.testing.assert_allclose(world[0]["accum2"]["losses"], jl, rtol=1e-5)
    _assert_trees_close(world[0]["accum2"]["params"], jp)
    _ranks_agree(world, "accum2")


def test_moe_eval_matches_jax(world):
    leg = BY_NAME["eval"]
    jcfg = jt.ModelConfig(**CFG, dtype=jnp.float32)
    want = float(jt.make_eval_fn(jcfg, _jax_mesh(leg["mesh"]))(
        jt.init_params(jcfg, jax.random.key(0)), jnp.asarray(leg["tokens"])))
    for r in range(4):
        np.testing.assert_allclose(world[r]["eval"]["eval"], want, rtol=1e-5)


def test_moe_drop_case_keeps_jax_tokens(world):
    """Capacity factor 0.5 over dp 2: the global routing drops tokens, and
    the kept set (gathered over dp) equals the one the JAX layer keeps on
    the same inputs; routing each rank's tokens alone would keep another
    set. The losses of 3 steps equal JAX's."""
    res = world[0]["drop"]
    jcfg = jt.ModelConfig(**CFG, **DROP, dtype=jnp.float32)
    (route,) = res["routes"]
    layer = _jax_tree()["layers"][1]["moe"]
    y, _ = jm.moe_mlp(jnp.asarray(route["h"]), layer, 0.5)
    jax_kept = np.asarray(jnp.any(y != 0, axis=-1))
    logits = np.asarray(route["h"]) @ np.asarray(layer["wg"])
    np.testing.assert_array_equal(route["expert"], logits.argmax(-1))
    assert not route["kept"].all()                   # tokens were dropped
    np.testing.assert_array_equal(route["kept"].astype(bool), jax_kept)
    assert (route["kept_alone"] != route["kept"]).any()
    for r in range(1, 4):
        np.testing.assert_array_equal(world[r]["drop"]["routes"][0]["kept"],
                                      route["kept"])
    jl, jp, jaux = _jax_run(BY_NAME["drop"])
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(res["aux"], jaux, rtol=1e-5)
    _assert_trees_close(res["params"], jp)
    assert jcfg.moe_capacity_factor == 0.5


def test_moe_mesh_step_at_world_one_equals_single_device(tmp_path):
    """A gloo world of one rank in this process: the MoE mesh step (its
    routing gathers and reduces over groups of one) gives the
    single-device step's losses and params bit for bit, at the dropping
    capacity factor too."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(device_type="cpu")
        for kw in ({}, DROP):
            tcfg = tt.ModelConfig(**CFG, **kw, dtype=torch.float32)
            runs = []
            for m in (None, mesh):
                step, _, opt = tt.make_train_step(
                    tcfg, learning_rate=LR, device="cpu", mesh=m)
                params = params_from_jax(_jax_tree(), tcfg, device="cpu",
                                         dtype=torch.float32)
                state = opt.init(params)
                losses = [float(step(params, state, _tokens(4))[2])
                          for _ in range(STEPS)]
                runs.append((losses, tt._leaves(params)))
            assert runs[0][0] == runs[1][0]
            for a, b in zip(runs[0][1], runs[1][1]):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
