"""The port's sharded train step against the JAX package's on the same
mesh, weights and tokens, on the CPU.

The JAX step runs in this process over the 8 host devices; the port's
runs SPMD in one spawned gloo world of 4 ranks (``torch_worlds.py``),
which runs every leg of this file once, in a module fixture. Weights are
a JAX ``init_params`` tree through the weight bridge and
``shard_params``; tokens are numpy draws. The config is
``dryrun_multichip``'s (vocab 512, d 64, 4 heads, 2 layers, ff 128,
max_seq 64) at f32, and a rope + GQA (2 kv heads) variant.

Tolerances (f32): losses 1e-5 relative over 3 steps; gathered params
1e-5 absolute after step 3 (both sides compute the same products in f32
and differ in summation order, the collectives' included), except where
Adam's first update g/(|g| + eps) turns on a gradient that is rounding
noise (|g| near eps): there the two frameworks may move an element by up
to lr per step apart, as ``test_torch_train.py`` bounds it: at most 1e-4
of a tree's elements, each within 2 * lr * steps + 1e-5 (one element of
the accumulation leg, 1.3e-5 off, measured).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import parallel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402

import torch_worlds  # noqa: E402

LR = 1e-3
STEPS = 3
CFG = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=64)
VARIANTS = {"dense": {}, "rope-gqa": dict(pos="rope", n_kv_heads=2)}
MESHES = [(1, 2, 2), (2, 2, 1), (2, 1, 2)]


def _tokens(*lead, seed=7):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=(*lead, 33)).astype(np.int32)


_TREES = {}


def _jax_tree(kw):
    """JAX init_params(key(0)) at f32 for a variant (drawn once)."""
    key = tuple(sorted(kw.items()))
    if key not in _TREES:
        jcfg = jt.ModelConfig(**CFG, **kw, dtype=jnp.float32)
        _TREES[key] = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    return _TREES[key]


def _mesh_id(mesh):
    return "x".join(map(str, mesh))


LEGS = [
    dict(name=f"{v}-{_mesh_id(m)}", mesh=m, kw=VARIANTS[v], tokens=_tokens(4))
    for m in MESHES for v in VARIANTS
] + [
    dict(name="accum2", mesh=(2, 2, 1), kw={}, tokens=_tokens(2, 4),
         opts=dict(accum_steps=2)),
    dict(name="master-ema", mesh=(1, 2, 2), kw=VARIANTS["rope-gqa"],
         tokens=_tokens(4), opts=dict(master_weights=True, ema_decay=0.9)),
] + [
    dict(name=f"eval-{_mesh_id(m)}", mesh=m, kw=VARIANTS["rope-gqa"],
         tokens=_tokens(4, seed=9), eval=True)
    for m in MESHES
]
BY_NAME = {leg["name"]: leg for leg in LEGS}


@pytest.fixture(scope="module")
def world():
    """Every leg's results from each of the 4 ranks."""
    spec = dict(lr=LR, steps=STEPS, legs=[
        dict(name=leg["name"], mesh=leg["mesh"], cfg=dict(CFG, **leg["kw"]),
             tree=_jax_tree(leg["kw"]), tokens=leg["tokens"],
             opts=leg.get("opts", {}), eval=leg.get("eval", False))
        for leg in LEGS
    ] + [dict(name="checks", checks=True)])
    return torch_worlds.run_world(torch_worlds.train_legs, 4, spec)


def _jax_run(leg):
    jcfg = jt.ModelConfig(**CFG, **leg["kw"], dtype=jnp.float32)
    mesh = jt.make_mesh(4, dp=leg["mesh"][0], sp=leg["mesh"][1],
                        tp=leg["mesh"][2])
    step, init_all, _ = jt.make_train_step(
        jcfg, mesh, learning_rate=LR, **leg.get("opts", {}))
    params, opt = init_all(jax.random.key(0))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(leg["tokens"]))
        losses.append(float(loss))
    return np.array(losses), jax.device_get(params), opt


def _assert_trees_close(got, want, tol=1e-5, frac=1e-4):
    """Every element within tol, but for Adam's sign-of-noise elements:
    at most ``frac`` of them, each within 2 * lr * steps + tol."""
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert [x.shape for x in g] == [x.shape for x in w]
    diff = [np.abs(x - np.asarray(y, np.float32)) for x, y in zip(g, w)]
    total = sum(d.size for d in diff)
    off = sum(int((d > tol).sum()) for d in diff)
    assert off <= frac * total, f"{off} of {total} elements off by > {tol}"
    assert max(float(d.max()) for d in diff) <= 2 * LR * STEPS + tol


def _ranks_agree(world, name, key="params"):
    first = jax.tree_util.tree_leaves(world[0][name][key])
    for r in range(1, len(world)):
        for a, b in zip(first, jax.tree_util.tree_leaves(world[r][name][key])):
            assert np.array_equal(a, b), f"rank {r} differs in {name}"


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_defaults_match_jax(n):
    """make_mesh's axis sizes, defaults and explicit, are JAX's."""
    for kw in ({}, dict(sp=2), dict(tp=1), dict(dp=1, sp=1)):
        try:
            want = tuple(jt.make_mesh(n, **kw).shape.values())
        except AssertionError as e:
            with pytest.raises(AssertionError, match=str(e).split(" !=")[0]):
                parallel.mesh_shape(n, **kw)
            continue
        assert parallel.mesh_shape(n, **kw) == want
    with pytest.raises(AssertionError, match="mesh 3x1x1x1 != 4 devices"):
        parallel.mesh_shape(4, dp=3, tp=1)


def test_make_mesh_checks(world):
    """make_mesh's process model: a gloo group with a CUDA mesh raises, an
    n_devices other than the world size raises, dims are named as JAX's;
    without a process group it raises."""
    for r, res in enumerate(world):
        checks = res["checks"]
        assert checks["dims"] == ["dp", "sp", "tp", "ep"]
        assert checks["shape"] == [1, 1, 4, 1]   # JAX's default for 4
        assert "needs the nccl backend" in checks["cuda_on_gloo"]
        assert "n_devices 2 != world size 4" in checks["wrong_n"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh(1, device_type="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_specs_match_jax(variant):
    """param_shardings' specs are the JAX PartitionSpecs, leaf for leaf;
    MoE layers carry JAX's moe specs."""
    from jax.sharding import NamedSharding

    kw = dict(VARIANTS[variant], moe_experts=4)
    jcfg = jt.ModelConfig(**CFG, **kw, dtype=jnp.float32)
    tcfg = tt.ModelConfig(**CFG, **kw, dtype=torch.float32)
    want = jax.tree_util.tree_map(
        lambda ns: tuple(ns.spec),
        jt._full_param_shardings(jt.make_mesh(8, dp=2, sp=2, tp=2), jcfg),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    fake = types.SimpleNamespace(shape=(2, 2, 2, 1),
                                 mesh_dim_names=parallel.MESH_AXES)
    got = parallel.full_param_shardings(fake, tcfg)

    def same(path, shape):
        pad = (None,) * len(shape)
        g = parallel._spec_at(got, path)
        w = parallel._spec_at(want, path)
        assert (g + pad)[:len(shape)] == (w + pad)[:len(shape)], path

    tt._tree_map(same, tt.jax_layout_shapes(tcfg))


def test_gqa_and_moe_mesh_checks():
    """JAX's GQA assert (tp must divide the kv heads), and MoE over a mesh
    whose ep does not split the experts evenly."""
    fake = types.SimpleNamespace(shape=(1, 1, 4, 1),
                                 mesh_dim_names=parallel.MESH_AXES,
                                 device_type="cpu", size=lambda: 4)
    gqa = tt.ModelConfig(**CFG, n_kv_heads=2, dtype=torch.float32)
    with pytest.raises(AssertionError, match="divisible by tp=4"):
        parallel.full_param_shardings(fake, gqa)
    with pytest.raises(AssertionError, match="divisible by tp=4"):
        jt._full_param_shardings(
            jt.make_mesh(4, dp=1, sp=1, tp=4),
            jt.ModelConfig(**CFG, n_kv_heads=2, dtype=jnp.float32))
    moe = tt.ModelConfig(**CFG, moe_experts=4, dtype=torch.float32)
    fake.shape = (1, 1, 1, 3)
    with pytest.raises(ValueError, match="split over ep=3"):
        tt.make_train_step(moe, device="cpu", mesh=fake)


@pytest.mark.parametrize(
    "name", [leg["name"] for leg in LEGS[:6]])
def test_sharded_step_matches_jax(world, name):
    """3 steps on dp/sp/tp meshes (sp > 1 runs the ring): losses and the
    gathered params equal JAX's; every rank holds the same loss and
    gathers the same params (replicated leaves agree over tp)."""
    leg = BY_NAME[name]
    jl, jp, _ = _jax_run(leg)
    for r in range(4):
        np.testing.assert_allclose(world[r][name]["losses"], jl, rtol=1e-5)
    assert world[0][name]["losses"][-1] < world[0][name]["losses"][0]
    _assert_trees_close(world[0][name]["params"], jp)
    _ranks_agree(world, name)


def test_accum_steps_matches_jax(world):
    leg = BY_NAME["accum2"]
    jl, jp, _ = _jax_run(leg)
    np.testing.assert_allclose(world[0]["accum2"]["losses"], jl, rtol=1e-5)
    _assert_trees_close(world[0]["accum2"]["params"], jp)
    _ranks_agree(world, "accum2")


def test_master_weights_and_ema_match_jax(world):
    """master_weights (f32 live leaves at an f32 config, f32 masters) with
    ema_decay 0.9 over (1, 2, 2): losses, params and the EMA tree."""
    leg = BY_NAME["master-ema"]
    jl, jp, jopt = _jax_run(leg)
    res = world[0]["master-ema"]
    np.testing.assert_allclose(res["losses"], jl, rtol=1e-5)
    _assert_trees_close(res["params"], jp)
    _assert_trees_close(res["ema"], jax.device_get(jt.ema_params(jopt)))
    _ranks_agree(world, "master-ema")
    _ranks_agree(world, "master-ema", "ema")


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_eval_fn_matches_jax(world, mesh):
    name = f"eval-{_mesh_id(mesh)}"
    leg = BY_NAME[name]
    jcfg = jt.ModelConfig(**CFG, **leg["kw"], dtype=jnp.float32)
    jmesh = jt.make_mesh(4, dp=mesh[0], sp=mesh[1], tp=mesh[2])
    want = float(jt.make_eval_fn(jcfg, jmesh)(
        jt.init_params(jcfg, jax.random.key(0)), jnp.asarray(leg["tokens"])))
    for r in range(4):
        np.testing.assert_allclose(world[r][name]["eval"], want, rtol=1e-5)


def test_mesh_step_at_world_one_equals_single_device_step(tmp_path):
    """A gloo world of one rank in this process: the mesh step (its
    collectives over groups of one, the vocab-parallel loss at tp 1) gives
    the single-device step's losses and params bit for bit, zero1 at dp 1
    is a no-op, and the mesh eval equals the plain eval."""
    import torch.distributed as dist

    from elastic_tpu_agent_torch.workloads.weights import params_from_jax

    tcfg = tt.ModelConfig(**CFG, **VARIANTS["rope-gqa"], dtype=torch.float32)
    tree = _jax_tree(VARIANTS["rope-gqa"])
    tokens = _tokens(4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1, 1, 1)
        for opts in ({}, dict(zero1=True, master_weights=True,
                              ema_decay=0.9)):
            runs = []
            for m in (None, mesh):
                step, _, opt = tt.make_train_step(
                    tcfg, learning_rate=LR, device="cpu", mesh=m, **opts)
                params = params_from_jax(tree, tcfg, device="cpu",
                                         dtype=torch.float32)
                state = opt.init(params)
                losses = [float(step(params, state, tokens)[2])
                          for _ in range(STEPS)]
                runs.append((losses, tt._leaves(params),
                             tt._leaves(state.get("ema", {}))))
            assert runs[0][0] == runs[1][0]
            for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
                assert torch.equal(a, b)
        params = params_from_jax(tree, tcfg, device="cpu",
                                 dtype=torch.float32)
        assert float(tt.make_eval_fn(tcfg, "cpu", mesh=mesh)(
            params, tokens)) == float(tt.make_eval_fn(tcfg, "cpu")(
                params, tokens))
    finally:
        dist.destroy_process_group()
