"""The port's sharded decode (``generate(..., mesh=)``,
``decode_shardings``) against the JAX package's, on the CPU.

The JAX side runs in this process over the host devices; the port's runs
SPMD in one spawned gloo world of 4 ranks (``torch_worlds.py``) at
(dp, tp) = (2, 2), (4, 1) and (1, 4). Configs: the dryrun's ``gcfg``
(vocab 256, d 64, 4 heads, 2 layers, ff 128, max_seq 64, rope) and a GQA
variant (8 heads over 4 kv heads, so that tp 4 splits them), f32; an
int8 tree (JAX ``quantize_params``) at (2, 2). Weights are JAX
``init_params`` trees through the weight bridge; prompts are numpy draws
(batch 4, 6 tokens, 8 new).

Greedy streams are held token for token; a sampled sharded stream must
equal the port's single-device stream from the same generator seed.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import parallel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
)

import torch_worlds  # noqa: E402

# the packages' generate() functions shadow their modules
jg = importlib.import_module("elastic_tpu_agent.workloads.generate")
tg = importlib.import_module("elastic_tpu_agent_torch.workloads.generate")

GCFG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq=64, pos="rope")
VARIANTS = {"dense": GCFG, "gqa": dict(GCFG, n_heads=8, n_kv_heads=4)}
MESHES = [(2, 2), (4, 1), (1, 4)]
NEW = 8
PROMPT = np.random.default_rng(3).integers(0, GCFG["vocab"], size=(4, 6))
SAMPLING = dict(temperature=0.8, top_k=8, top_p=0.9)

_TREES = {}


def _tree(variant, int8=False):
    if (variant, int8) not in _TREES:
        jcfg = jt.ModelConfig(**VARIANTS[variant], dtype=jnp.float32)
        tree = jt.init_params(jcfg, jax.random.key(2))
        if int8:
            tree = jq.quantize_params(tree)
        _TREES[variant, int8] = jax.device_get(tree)
    return _TREES[variant, int8]


def _mid(mesh):
    return f"dp{mesh[0]}tp{mesh[1]}"


LEGS = [dict(name=f"{v}-{_mid(m)}", variant=v, mesh=m)
        for v in VARIANTS for m in MESHES] + [
    dict(name="int8-dp2tp2", variant="dense", mesh=(2, 2), int8=True),
    dict(name="sampled-dp2tp2", variant="gqa", mesh=(2, 2),
         sampling=SAMPLING, seed=3),
]
BY_NAME = {leg["name"]: leg for leg in LEGS}


@pytest.fixture(scope="module")
def world():
    spec = dict(legs=[
        dict(name=leg["name"], mesh=leg["mesh"], cfg=VARIANTS[leg["variant"]],
             tree=_tree(leg["variant"], leg.get("int8", False)),
             prompt=PROMPT, new=NEW, sampling=leg.get("sampling", {}),
             seed=leg.get("seed", 0))
        for leg in LEGS])
    return torch_worlds.run_world(torch_worlds.decode_legs, 4, spec)


def _jax_streams(leg):
    """(JAX's sharded stream on the leg's mesh, its single-device one)."""
    jcfg = jt.ModelConfig(**VARIANTS[leg["variant"]], dtype=jnp.float32)
    tree = jax.tree.map(jnp.asarray, _tree(leg["variant"],
                                           leg.get("int8", False)))
    dp, tp = leg["mesh"]
    mesh = jt.make_mesh(4, dp=dp, sp=1, tp=tp, ep=1)
    shard, _ = jg.decode_shardings(mesh, jcfg, params=tree)
    got = jg.generate(jax.device_put(tree, shard), jnp.asarray(PROMPT), jcfg,
                      max_new_tokens=NEW, mesh=mesh)
    want = jg.generate(tree, jnp.asarray(PROMPT), jcfg, max_new_tokens=NEW)
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("name", [leg["name"] for leg in LEGS[:7]])
def test_sharded_greedy_matches_jax(world, name):
    """Greedy streams on every rank equal JAX's sharded and single-device
    streams, token for token (dense and GQA at three meshes, int8)."""
    leg = BY_NAME[name]
    sharded, single = _jax_streams(leg)
    np.testing.assert_array_equal(sharded, single)
    for r in range(4):
        np.testing.assert_array_equal(world[r][name], single)


def test_sharded_sampled_equals_single_device(world):
    """A sampled sharded stream draws the whole batch's uniforms from the
    one generator: it equals the single-device stream of the same seed."""
    leg = BY_NAME["sampled-dp2tp2"]
    cfg = tt.ModelConfig(**VARIANTS["gqa"], dtype=torch.float32)
    params = params_from_jax(_tree("gqa"), cfg, device="cpu",
                             dtype=torch.float32)
    want = tg.generate(params, PROMPT, cfg, NEW, device="cpu",
                       generator=torch.Generator().manual_seed(3),
                       **SAMPLING).numpy()
    greedy = tg.generate(params, PROMPT, cfg, NEW, device="cpu").numpy()
    assert not np.array_equal(want, greedy)
    for r in range(4):
        np.testing.assert_array_equal(world[r][leg["name"]], want)


class _FakeMesh:
    def __init__(self, dp, tp):
        self.shape = (dp, 1, tp, 1)
        self.mesh_dim_names = parallel.MESH_AXES


def _specs(tree):
    return jax.tree_util.tree_map(
        lambda ns: tuple(ns.spec), tree,
        is_leaf=lambda x: isinstance(x, NamedSharding))


def _pad(spec, n):
    return (tuple(spec) + (None,) * n)[:n]


@pytest.mark.parametrize("variant,int8", [("dense", False), ("gqa", False),
                                          ("dense", True)])
def test_decode_shardings_match_jax(variant, int8):
    """Param and cache split specs equal JAX's, leaf for leaf (int8: the
    scale's keepdims axes unsplit)."""
    jcfg = jt.ModelConfig(**VARIANTS[variant], dtype=jnp.float32)
    tcfg = tt.ModelConfig(**VARIANTS[variant], dtype=torch.float32)
    tree = _tree(variant, int8)
    jp, jcache = jg.decode_shardings(jt.make_mesh(4, dp=2, sp=1, tp=2, ep=1),
                                     jcfg, params=tree if int8 else None)
    full = params_from_jax(tree, tcfg, device="cpu", dtype=torch.float32)
    tp_specs, tcache = tg.decode_shardings(_FakeMesh(2, 2), tcfg,
                                           full if int8 else None)
    want = _specs(jp)

    def same(path, x):
        w, g = want, tp_specs
        for p in path:
            w, g = w[p], g[p]
        if isinstance(x, dict):
            for k in ("q", "s"):
                assert _pad(g[k], x[k].dim()) == _pad(w[k], x[k].dim()), path
        else:
            assert _pad(g, x.dim()) == _pad(w, x.dim()), path

    tt._tree_map(same, full)
    assert tcache.k == tcache.v == tuple(jcache.k.spec)
    if int8:
        assert tp_specs["lm_head"] == {"q": (None, "tp"), "s": (None, "tp")}
        assert tp_specs["layers"][0]["wo"]["s"] == (None, None, None)


def test_decode_shardings_rejects_bad_tp():
    """JAX's kv-heads assert, with its message."""
    cfg = dict(GCFG, n_kv_heads=2)
    with pytest.raises(AssertionError) as want:
        jg.decode_shardings(jt.make_mesh(4, dp=1, sp=1, tp=4, ep=1),
                            jt.ModelConfig(**cfg, dtype=jnp.float32))
    with pytest.raises(AssertionError) as got:
        tg.decode_shardings(_FakeMesh(1, 4),
                            tt.ModelConfig(**cfg, dtype=torch.float32))
    assert str(got.value) == str(want.value)
