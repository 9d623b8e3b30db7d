"""The port's pipelined flagship transformer (``transformer_pipeline.py``:
GPipe and 1F1B) against the JAX package's, on the CPU.

Configs: the dryrun's ``pcfg`` (vocab 256, d 32, 2 heads, n_layers = pp,
ff 64, max_seq 32) and a rope variant with n_layers = 2 pp; seq 16,
m 4 microbatches of 2 rows, f32. Weights are a JAX
``init_pipeline_params`` tree through ``weights.pipeline_params_from_jax``;
tokens are numpy draws. The oracle is JAX's unpipelined loss (the
stacked weights applied stage after stage by JAX ``_stage_fn``, as
``tests/test_transformer_pipeline.py`` builds it); the JAX pipelined steps
run on this process's host devices. The port runs the ``StackedPipe`` in
this process and the ``ProcessGroupPipe`` in one spawned gloo world of 4
ranks, at (pp, dp) = (4, 1) and (2, 2).

Tolerances (f32): losses 1e-5 relative; gradients and params after 3
steps within atol 2e-5, rtol 1e-4 (JAX's own pipeline bound).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent.workloads import transformer_pipeline as jtp  # noqa: E402
from elastic_tpu_agent.workloads.pipeline import make_pipeline_mesh  # noqa: E402
from elastic_tpu_agent_torch.workloads import pipeline as tpl  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads import (  # noqa: E402
    transformer_pipeline as ttp,
)
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_to_jax,
    pipeline_params_from_jax,
)

import torch_worlds  # noqa: E402

STEPS = 3
M, MB, S = 4, 2, 16
BASE = dict(vocab=256, d_model=32, n_heads=2, d_ff=64, max_seq=32)
TOL = dict(atol=2e-5, rtol=1e-4)
MESHES = [(4, 1), (2, 2)]
SCHEDULES = ("gpipe", "1f1b")


def _kw(variant, pp):
    if variant == "pcfg":
        return dict(BASE, n_layers=pp)
    return dict(BASE, n_layers=2 * pp, pos="rope")


VARIANTS = ("pcfg", "rope")


def _cfgs(variant, pp):
    kw = _kw(variant, pp)
    return (jt.ModelConfig(**kw, dtype=jnp.float32),
            tt.ModelConfig(**kw, dtype=torch.float32))


_TREES = {}


def _tree(variant, pp):
    if (variant, pp) not in _TREES:
        jcfg, _ = _cfgs(variant, pp)
        _TREES[variant, pp] = jax.device_get(
            jtp.init_pipeline_params(jcfg, jax.random.key(0), pp))
    return _TREES[variant, pp]


TOKENS = np.random.default_rng(1).integers(0, BASE["vocab"],
                                           size=(M, MB, S + 1))


def _oracle_loss(jcfg, pp):
    """JAX's unpipelined loss of the stacked weights."""

    def loss(params, toks):
        xs = jtp._embed_fn(params, toks[:, :, :-1], jcfg)
        head = {"final_norm_scale": params["final_norm_scale"],
                "lm_head": params["lm_head"]}

        def per_micro(x, tgt):
            for p in range(pp):
                x = jtp._stage_fn(jax.tree.map(lambda a, p=p: a[p],
                                               params["stages"]), x, jcfg)
            return jtp._head_loss(x, head, tgt, jcfg)

        return jnp.mean(jax.vmap(per_micro)(xs, toks[:, :, 1:]))

    return loss


@pytest.fixture(scope="module")
def oracle():
    """(loss, grads) of JAX's unpipelined oracle for each variant and pp."""
    out = {}
    for variant in VARIANTS:
        for pp in (4, 2):
            jcfg, _ = _cfgs(variant, pp)
            fn = _oracle_loss(jcfg, pp)
            params = jax.tree.map(jnp.asarray, _tree(variant, pp))
            loss, grads = jax.jit(jax.value_and_grad(fn))(
                params, jnp.asarray(TOKENS))
            out[variant, pp] = (float(loss), jax.device_get(grads))
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """Losses and params of 3 JAX pipelined steps per schedule and mesh
    (pcfg), and on (2, 2) for the rope variant."""
    out = {}
    for variant, mesh in [("pcfg", m) for m in MESHES] + [("rope", (2, 2))]:
        jcfg, _ = _cfgs(variant, mesh[0])
        jmesh = make_pipeline_mesh(pp=mesh[0], dp=mesh[1])
        for schedule in SCHEDULES:
            step, init_all = jtp.make_pipeline_transformer_step(
                jcfg, jmesh, n_micro=M, schedule=schedule)
            _, opt = init_all(jax.random.key(0))
            params = jax.tree.map(jnp.asarray, _tree(variant, mesh[0]))
            losses = []
            for _ in range(STEPS):
                params, opt, loss = step(params, opt, jnp.asarray(TOKENS))
                losses.append(float(loss))
            out[variant, mesh, schedule] = (np.array(losses),
                                            jax.device_get(params))
    return out


def _name(variant, mesh, schedule):
    return f"{variant}-pp{mesh[0]}dp{mesh[1]}-{schedule}"


WORLD_STEPS = [("pcfg", m, s) for m in MESHES for s in SCHEDULES] + [
    ("rope", (2, 2), s) for s in SCHEDULES]


@pytest.fixture(scope="module")
def world():
    legs = []
    for variant, mesh, schedule in WORLD_STEPS:
        legs.append(dict(name=_name(variant, mesh, schedule), kind="step",
                         mesh=mesh, schedule=schedule,
                         cfg=_kw(variant, mesh[0]),
                         tree=_tree(variant, mesh[0]), tokens=TOKENS))
    for mesh in MESHES:
        legs.append(dict(name=f"grads-pp{mesh[0]}dp{mesh[1]}",
                         kind="grads_1f1b", mesh=mesh,
                         cfg=_kw("pcfg", mesh[0]),
                         tree=_tree("pcfg", mesh[0]), tokens=TOKENS))
    return torch_worlds.run_world(torch_worlds.pipeline_legs, 4,
                                  dict(legs=legs, steps=STEPS))


def _close(got, want):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def _stacked(variant, pp):
    _, tcfg = _cfgs(variant, pp)
    return tcfg, pipeline_params_from_jax(_tree(variant, pp), tcfg, pp,
                                          device="cpu")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_stacked_first_loss_matches_oracle(oracle, variant, schedule):
    """Step 0's loss of each schedule on the StackedPipe at pp 4 equals
    JAX's unpipelined loss."""
    tcfg, params = _stacked(variant, 4)
    step, _ = ttp.make_pipeline_transformer_step(
        tcfg, tpl.StackedPipe(4), n_micro=M, schedule=schedule, device="cpu")
    loss = step(params, tt.AdamW(1e-3).init(params), TOKENS)[2]
    np.testing.assert_allclose(float(loss), oracle[variant, 4][0], rtol=1e-5)


def _grads_1f1b(pipe, tcfg, params):
    toks = torch.from_numpy(TOKENS).long()
    embed = {k: params[k].requires_grad_() for k in ("embed", "pos_embed")
             if k in params}
    with torch.enable_grad():
        xs = ttp._embed_fn(embed, toks[:, :, :-1], tcfg)
    g_stage, g_head, dxs, loss = ttp.pipeline_1f1b_grads(
        pipe, tcfg, params["stages"], ttp._split_head(params), xs,
        toks[:, :, 1:])
    g_embed = dict(zip(embed, torch.autograd.grad(xs, list(embed.values()),
                                                  dxs)))
    return dict(loss=float(loss), head=params_to_jax(g_head),
                embed=params_to_jax(g_embed),
                stages=params_to_jax(g_stage))


def _check_grads(res, want_loss, want):
    np.testing.assert_allclose(res["loss"], want_loss, rtol=1e-5)
    _close(res["stages"], want["stages"])
    for k in ("final_norm_scale", "lm_head"):
        np.testing.assert_allclose(res["head"][k], want[k], **TOL)
    for k in res["embed"]:
        np.testing.assert_allclose(res["embed"][k], want[k], **TOL)
    assert set(res["embed"]) == {"embed", "pos_embed"} & set(want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pp", [4, 2])
def test_stacked_1f1b_grads_match_oracle(oracle, variant, pp):
    """pipeline_1f1b_grads (stage, head) and the embedding's gradients
    from its dxs equal jax.grad of the unpipelined loss."""
    tcfg, params = _stacked(variant, pp)
    res = _grads_1f1b(tpl.StackedPipe(pp), tcfg, params)
    _check_grads(res, *oracle[variant, pp])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"pp{m[0]}dp{m[1]}")
def test_process_group_1f1b_grads_match_oracle(world, oracle, mesh):
    """The same over 4 ranks: every rank holds the whole gradients."""
    for r in range(4):
        _check_grads(world[r][f"grads-pp{mesh[0]}dp{mesh[1]}"],
                     *oracle["pcfg", mesh[0]])


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"pp{m[0]}dp{m[1]}")
def test_stacked_steps_match_jax(jax_steps, mesh, schedule):
    """3 steps on the StackedPipe at the mesh's pp: losses and params equal
    JAX's pipelined step on the (pp, dp) mesh (dp changes only the
    summation order)."""
    want_l, want_p = jax_steps["pcfg", mesh, schedule]
    tcfg, params = _stacked("pcfg", mesh[0])
    step, _ = ttp.make_pipeline_transformer_step(
        tcfg, tpl.StackedPipe(mesh[0]), n_micro=M, schedule=schedule,
        device="cpu")
    state = tt.AdamW(1e-3).init(params)
    got = [float(step(params, state, TOKENS)[2]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want_l, rtol=1e-5)
    _close(params_to_jax(params), want_p)


@pytest.mark.parametrize("variant,mesh,schedule", WORLD_STEPS,
                         ids=[_name(*x) for x in WORLD_STEPS])
def test_process_group_steps_match_jax(world, jax_steps, variant, mesh,
                                       schedule):
    """3 steps over 4 ranks: every rank's losses and gathered params equal
    JAX's pipelined step on the same mesh."""
    want_l, want_p = jax_steps[variant, mesh, schedule]
    for r in range(4):
        res = world[r][_name(variant, mesh, schedule)]
        np.testing.assert_allclose(res["losses"], want_l, rtol=1e-5)
        _close(res["params"], want_p)


def test_1f1b_recomputes_and_bounds_its_stash(monkeypatch):
    """1F1B runs each stage forward twice a microbatch (once without a
    graph, once recomputed under grad for the backward), the last stage
    once (its backward half takes the microbatch in the same tick), and
    each stage holds at most 2 pp stage inputs at a time, however many
    microbatches run (stage 0 holds 2 pp - 1 at pp 4)."""
    pp, m = 4, 12
    tcfg, params = _stacked("pcfg", pp)
    calls, held, peak = [], {}, [0]
    real = ttp._stage_fn

    def counted(sp, x, cfg):
        calls.append(torch.is_grad_enabled())
        mine = held.setdefault(id(sp), set())     # this stage's inputs
        if torch.is_grad_enabled():
            mine.discard(x.data_ptr())
        else:
            mine.add(x.data_ptr())
            peak[0] = max(peak[0], len(mine))
        return real(sp, x, cfg)

    monkeypatch.setattr(ttp, "_stage_fn", counted)
    toks = np.random.default_rng(2).integers(0, BASE["vocab"],
                                             size=(m, MB, S + 1))
    step, _ = ttp.make_pipeline_transformer_step(
        tcfg, tpl.StackedPipe(pp), n_micro=m, schedule="1f1b", device="cpu")
    step(params, tt.AdamW(1e-3).init(params), toks)
    assert calls.count(False) == m * (pp - 1)
    assert calls.count(True) == m * pp
    assert peak[0] == 2 * pp - 1


@pytest.mark.parametrize("bad", ["moe", "gqa", "layers"])
def test_pipeline_config_asserts_match_jax(bad):
    kw = dict(BASE, n_layers=4)
    kw.update({"moe": dict(moe_experts=4), "gqa": dict(n_kv_heads=1),
               "layers": dict(n_layers=6)}[bad])
    with pytest.raises(AssertionError) as want:
        jtp.init_pipeline_params(jt.ModelConfig(**kw), jax.random.key(0), 4)
    tcfg = tt.ModelConfig(**kw)
    for call in (lambda: ttp.init_pipeline_params(
                     tcfg, torch.Generator(), 4, device="cpu"),
                 lambda: ttp.make_pipeline_transformer_step(
                     tcfg, tpl.StackedPipe(4), n_micro=M, device="cpu")):
        with pytest.raises(AssertionError) as got:
            call()
        assert str(got.value) == str(want.value)
