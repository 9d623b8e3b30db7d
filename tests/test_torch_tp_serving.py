"""The port's tensor-parallel ServingEngine (``partitioner.py``,
``ServingEngine(mesh=)``) against the JAX package's, on the CPU.

The JAX side runs in this process over the host devices; the port's runs
SPMD in one spawned gloo world of 4 ranks (``torch_worlds.py``
``tp_serving_legs``), at mp 4 (dp 1) and at mp 2 (dp 2: two mp-2
engines). Every rank runs the same engine on the same requests, so every
rank must return the same results. Config: JAX ``tests/test_tp_serving.py``'s
(vocab 96, d 32, 4 heads, 2 layers, ff 64, f32), weights a JAX
``init_params`` tree through the weight bridge.

Greedy streams and the pool occupancy after every step are held exactly
against JAX's TP engine and the single-device engines: the split changes
only where sums are cut, which f32 greedy decoding does not see on these
prompts. Sampled streams are held against the port's single-device
engine (the two frameworks' random streams differ). kv_int8's first-step
logits sit within 1e-4 of the single-device int8 engine's: the quantizer
rounds each rank's K/V alike, and the rest is f32 summation order.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import partitioner as jpart  # noqa: E402
from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import serving as js  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    partitioner as tpart,
)

import torch_worlds  # noqa: E402

BASE = dict(vocab=96, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=96)
ENGINE = dict(slots=2, max_len=64, prompt_buckets=(8,), block_size=4)
CHURN = dict(ENGINE, slots=1)
PREFIX = dict(ENGINE, prompt_buckets=(4, 16), prefix_cache=True)
ADMISSIONS = ((5, 17, 42), (61, 3, 9))
PROMPTS = ((5, 17, 42), (61, 3, 9, 24, 7))
SYSTEM = (7, 7, 30, 2, 51, 11, 29, 4)
TAILS = ((5, 17), (61, 3), (9, 1, 2))
SAMPLING = ({"temperature": 0.8, "top_k": 20}, {"temperature": 1.0})
INT8_LOGITS_TOL = 1e-4
WORLD = 4
MPS = (4, 2)

_TREES = {}


def _cfg(**kw):
    return jt.ModelConfig(**dict(BASE, **kw), dtype=jnp.float32,
                          attn="reference")


def _tree(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _TREES:
        _TREES[key] = jax.device_get(jt.init_params(_cfg(**kw),
                                                    jax.random.key(0)))
    return _TREES[key]


def _leg(name, kind, cfg, mps=MPS, **extra):
    return dict(name=name, kind=kind, cfg=dict(BASE, **cfg), mps=mps,
                tree=_tree(**cfg), **extra)


LEGS = [
    _leg("rope", "serve", dict(pos="rope"), engine=ENGINE,
         admissions=ADMISSIONS),
    _leg("gqa_learned", "serve", dict(pos="learned", n_kv_heads=2),
         mps=(2,), engine=ENGINE, admissions=ADMISSIONS),
    _leg("churn", "churn", dict(pos="rope"), engine=CHURN, prompts=PROMPTS),
    _leg("prefix", "prefix", dict(pos="rope"), engine=PREFIX, system=SYSTEM,
         tails=TAILS),
    _leg("sampled", "sampled", dict(pos="rope"),
         engine=dict(ENGINE, seed=3), admissions=ADMISSIONS,
         sampling=SAMPLING),
    _leg("layout", "layout", dict(pos="rope"), engine=ENGINE),
    _leg("int8", "int8", dict(pos="rope"),
         engine=dict(CHURN, kv_int8=True), admissions=ADMISSIONS),
    _leg("refusals", "refusals", dict(pos="rope"), mps=(4,), engine=ENGINE,
         gqa_tree=_tree(pos="rope", n_kv_heads=2)),
    _leg("mesh", "mesh", dict(pos="rope")),
]


@pytest.fixture(scope="module")
def world():
    """Every leg in one 4-rank world: each rank's results."""
    return torch_worlds.run_world(torch_worlds.tp_serving_legs, WORLD,
                                  dict(legs=LEGS))


def _agreed(world, name):
    """A leg's results, which every rank must share."""
    for r in world[1:]:
        assert repr(r[name]) == repr(world[0][name])
    return world[0][name]


SCRIPTS = {
    "rope": lambda e: torch_worlds.serve_script(e, ADMISSIONS),
    "gqa_learned": lambda e: torch_worlds.serve_script(e, ADMISSIONS),
    "churn": lambda e: torch_worlds.churn_script(e, PROMPTS),
    "prefix": lambda e: torch_worlds.prefix_script(e, SYSTEM, TAILS),
}


@functools.cache
def _jax_run(name, mp=None):
    """A leg's script on JAX's engine: single-device, or tensor-parallel
    over a 4-device ("dp", "mp") mesh as the port's world."""
    leg = next(x for x in LEGS if x["name"] == name)
    cfg = _cfg(**{k: v for k, v in leg["cfg"].items() if k not in BASE})
    mesh = None if mp is None else jpart.make_serving_mesh(mp, WORLD)
    params = jax.tree.map(jnp.asarray, leg["tree"])
    return SCRIPTS[name](js.ServingEngine(params, cfg, **leg["engine"],
                                          mesh=mesh))


# JAX's TP engine at mp 2 stands for both meshes where JAX's own tests pin
# its streams to the single-device engine's; the rope leg runs both
@pytest.mark.parametrize("mp", MPS)
def test_tp_streams_and_occupancy_match_jax(world, mp):
    """Greedy streams and the occupancy after every step: the port's TP
    engine, its single-device engine, JAX's TP engine over 4 devices and
    JAX's single-device engine agree."""
    want = _jax_run("rope")
    got_tp, got_one = _agreed(world, "rope")[mp]
    assert _jax_run("rope", mp) == want
    assert got_tp == got_one == want


def test_tp_gqa_and_learned_positions(world):
    want = _jax_run("gqa_learned")
    got_tp, got_one = _agreed(world, "gqa_learned")[2]
    assert got_tp == got_one == _jax_run("gqa_learned", 2) == want


@pytest.mark.parametrize("mp", MPS)
def test_tp_engine_still_decodes_after_slot_churn(world, mp):
    want = _jax_run("churn", 2)
    got_tp, got_one = _agreed(world, "churn")[mp]
    assert got_tp == got_one == want
    assert all(used == 0 for _, used in got_tp)


@pytest.mark.parametrize("mp", MPS)
def test_tp_prefix_cache_matches_jax(world, mp):
    """Automatic hits, a registered prefix and a chunked admission under
    the mesh: streams, occupancy after every step and the hit count equal
    JAX's TP engine's and the single-device engines'."""
    want = _jax_run("prefix")
    got_tp, got_one = _agreed(world, "prefix")[mp]
    assert _jax_run("prefix", 2) == want
    assert got_tp == got_one == want
    assert want[2] >= len(TAILS) - 1


@pytest.mark.parametrize("mp", MPS)
def test_tp_sampled_streams_equal_single_device(world, mp):
    """Per-request temperature and top-k: every rank draws the
    single-device engine's tokens from the same seed (the logits are
    gathered over mp before sampling)."""
    got_tp, got_one = _agreed(world, "sampled")[mp]
    assert got_tp == got_one
    assert len(got_tp[0]) == 8 and len(got_tp[1]) == 5


def _spec_tree(shardings):
    """JAX NamedSharding tree -> plain spec lists, as the port's."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, list):
            return [leaf(v) for v in x]
        return list(x.spec)

    return leaf(shardings)


@pytest.mark.parametrize("mp", MPS)
def test_tp_split_specs_and_pool_match_jax(world, mp):
    """param_shardings leaf for leaf as JAX's PartitionSpecs (float and
    int8 trees: size-1 scale axes unsplit); the pool's spec, each rank's
    pool at g // mp kv heads and wo at n // mp heads; place_pool cuts this
    rank's kv heads of a full pool."""
    jmesh = jpart.make_serving_mesh(mp, WORLD)
    part = jpart.ServingPartitioner(jmesh, _cfg(pos="rope"))
    tree = jax.tree.map(jnp.asarray, _tree(pos="rope"))
    got = world[0]["layout"][mp]
    for r in world[1:]:
        mine = r["layout"][mp]
        assert repr({k: v for k, v in mine.items() if k != "placed_q"}) == (
            repr({k: v for k, v in got.items() if k != "placed_q"}))
    assert got["specs"] == _spec_tree(part.param_shardings(tree))
    assert got["int8_specs"] == _spec_tree(
        part.param_shardings(jq.quantize_params(tree)))
    assert tuple(got["pool_spec"]) == tuple(jpart.POOL_SPEC)
    cfg = _cfg(pos="rope")
    g, n = cfg.kv_heads // mp, cfg.n_heads // mp
    assert got["pool_shape"][3] == g and got["wo_shape"][0] == n
    # each rank's kv heads of the full pool (rank = dp index * mp + its
    # mp index)
    full = (np.arange(cfg.n_layers * 3 * 4 * cfg.kv_heads * cfg.head_dim)
            % 100).reshape(cfg.n_layers, 3, 4, cfg.kv_heads, cfg.head_dim)
    for rank, r in enumerate(world):
        lo = (rank % mp) * g
        np.testing.assert_array_equal(r["layout"][mp]["placed_q"],
                                      full[:, :, :, lo:lo + g])
    assert got["placed_s_shape"] == [cfg.n_layers, 3, 4, g, 1]


@pytest.mark.parametrize("mp", MPS)
def test_tp_int8_pool_runs_sharded(world, mp):
    """kv_int8 composes with the mesh: the quantized pool's q and s hold
    this rank's kv heads, the stream is valid, and the first decode step's
    logits sit within INT8_LOGITS_TOL of the single-device int8 engine's
    (JAX pins no more: quantization noise is not bit-pinned across
    reduction orders)."""
    got = _agreed(world, "int8")[mp]
    (tp_q, tp_s, tp_dtype), (one_q, _, _) = got["pools"]
    g = BASE["n_heads"] // mp
    assert tp_q[3] == tp_s[3] == g and one_q[3] == BASE["n_heads"]
    assert tp_s[-1] == 1 and tp_dtype == "torch.int8"
    stream = got["streams"][0]
    assert len(stream) == 5 and all(0 <= t < BASE["vocab"] for t in stream)
    tp_logits, one_logits = got["logits"]
    assert np.max(np.abs(tp_logits - one_logits)) <= INT8_LOGITS_TOL


def _jax_message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mesh_validation(world):
    """Every refusal with JAX's message: kv heads that mp does not divide,
    the paged kernel, a draft model, a shared pool, a mesh without "mp"
    and an MoE model."""
    got = _agreed(world, "refusals")
    gcfg = _cfg(pos="rope", n_kv_heads=2)
    cfg = _cfg(pos="rope")
    params = jax.tree.map(jnp.asarray, _tree(pos="rope"))
    gparams = jax.tree.map(jnp.asarray, _tree(pos="rope", n_kv_heads=2))
    mesh4 = jpart.make_serving_mesh(4, 4)
    want = dict(
        kv_heads=_jax_message(lambda: js.ServingEngine(
            gparams, gcfg, **ENGINE, mesh=mesh4)),
        paged_kernel=_jax_message(lambda: js.ServingEngine(
            params, cfg, **ENGINE, mesh=mesh4, paged_kernel=True)),
        draft=_jax_message(lambda: js.ServingEngine(
            params, cfg, **ENGINE, mesh=mesh4, draft_params=params,
            draft_cfg=cfg)),
        pool=_jax_message(lambda: js.ServingEngine(
            params, cfg, **ENGINE, mesh=mesh4, pool=js.SharedKVPool(
                cfg, block_size=4, pool_blocks=40))),
        no_mp=_jax_message(lambda: jpart.ServingPartitioner(
            jt.make_mesh(2, dp=2, sp=1, tp=1, ep=1), cfg)),
        moe=_jax_message(lambda: jpart.ServingPartitioner(
            mesh4, _cfg(pos="rope", moe_experts=2))),
    )
    assert got == want


def test_make_serving_mesh_shapes(world):
    got = _agreed(world, "mesh")
    assert got["mp2"] == [["dp", "mp"], [2, 2]]
    assert got["default"] == [["dp", "mp"], [1, 4]]
    assert "does not divide" in got["bad_mp"]
    assert got["bad_mp"] == "mp=3 does not divide 4 devices"
    assert "n_devices 8 != world size 4" in got["bad_n"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpart.make_serving_mesh(mp=1, device_type="cpu")
