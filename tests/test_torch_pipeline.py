"""The port's GPipe pipeline (``pipeline.py``) against the JAX
package's on the same stacked weights and inputs, on the CPU.

The toy vehicle is JAX's: ``init_stage_params`` residual gelu blocks,
``stage_block`` per stage. The port runs it through both transports: a
``StackedPipe`` in this process and a ``ProcessGroupPipe`` over one
spawned gloo world of 4 ranks (``torch_worlds.py``) at (pp, dp) = (4, 1)
and (2, 2), with m in {1, 3, 6} microbatches (m < pp included: the
backward's hand-offs then pair across bubble ticks).

Tolerances (f32): outputs and gradients within atol 2e-5, rtol 1e-4
(JAX's own pipeline bound); losses 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import pipeline as jpl  # noqa: E402
from elastic_tpu_agent_torch.workloads import pipeline as tpl  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    stage_params_from_jax,
)

import torch_worlds  # noqa: E402

D, FF, B = 16, 32, 8
MESHES = [(4, 1), (2, 2)]
MICRO = [1, 3, 6]
TOY_STEPS = 5
TOL = dict(atol=2e-5, rtol=1e-4)


def _tree(pp):
    return jax.device_get(jpl.init_stage_params(jax.random.key(0), pp, D, FF))


def _inputs(m, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, B, D)).astype(np.float32),
            rng.standard_normal((m, B, D)).astype(np.float32))


def _sequential(params, x, pp):
    """JAX ``test_pipeline_matches_sequential``'s oracle."""
    for i in range(pp):
        stage = jax.tree.map(lambda a, i=i: a[i], params)
        x = jax.vmap(lambda mb, s=stage: jpl.stage_block(s, mb))(x)
    return x


def _jax_want(pp, m):
    """(out, d/dparams, d/dx) of sum(sequential(params, x) * w)."""
    x, w = _inputs(m)
    params = _tree(pp)
    out = _sequential(params, jnp.asarray(x), pp)
    gp, gx = jax.grad(lambda p, x: jnp.sum(_sequential(p, x, pp) * w),
                      argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(out), jax.device_get(gp), np.asarray(gx)


def _leg_id(mesh, m):
    return f"pp{mesh[0]}dp{mesh[1]}-m{m}"


@pytest.fixture(scope="module")
def world():
    legs = []
    for mesh in MESHES:
        for m in MICRO:
            x, w = _inputs(m)
            legs.append(dict(name=_leg_id(mesh, m), kind="apply", mesh=mesh,
                             tree=_tree(mesh[0]), x=x, w=w))
        x, y = _inputs(6, seed=2)
        legs.append(dict(name=f"toy-{mesh[0]}x{mesh[1]}", kind="toy_step",
                         mesh=mesh, tree=_tree(mesh[0]), x=x, y=y, d=D,
                         ff=FF))
    spec = dict(legs=legs, toy_steps=TOY_STEPS)
    return torch_worlds.run_world(torch_worlds.pipeline_legs, 4, spec)


@pytest.mark.parametrize("pp", [4, 2])
@pytest.mark.parametrize("m", MICRO)
def test_stacked_pipeline_matches_sequential(pp, m):
    """StackedPipe: the outputs and the gradients (params and inputs) of
    sum(out * w) equal the sequential application's."""
    want, want_gp, want_gx = _jax_want(pp, m)
    x, w = _inputs(m)
    params = tpl.shard_stages(stage_params_from_jax(_tree(pp), device="cpu"),
                              tpl.StackedPipe(pp))
    for a in params.values():
        a.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = tpl.pipeline_apply(tpl.StackedPipe(pp), tpl.stage_block, params, xt)
    np.testing.assert_allclose(y.detach().numpy(), want, **TOL)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(params[k].grad.numpy(), want_gp[k], **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"pp{m[0]}dp{m[1]}")
@pytest.mark.parametrize("m", MICRO)
def test_process_group_pipeline_matches_sequential(world, mesh, m):
    """ProcessGroupPipe over 4 ranks: every rank holds the outputs of its
    dp rows (the last stage's, broadcast over pp), and the gradients of
    sum(out * w), gathered over pp and summed over dp, are the
    sequential ones."""
    want, want_gp, want_gx = _jax_want(mesh[0], m)
    for r in range(4):
        res = world[r][_leg_id(mesh, m)]
        np.testing.assert_allclose(res["y"], want, **TOL)
        np.testing.assert_allclose(res["dx"], want_gx, **TOL)
        for k in ("w1", "w2"):
            np.testing.assert_allclose(res["grads"][k], want_gp[k], **TOL)


def _jax_toy_losses(mesh):
    jmesh = jpl.make_pipeline_mesh(pp=mesh[0], dp=mesh[1])
    step, init_all = jpl.make_pipeline_train_step(jmesh, D, FF)
    _, opt = init_all(jax.random.key(0))
    params = jax.tree.map(jnp.asarray, _tree(mesh[0]))
    x, y = _inputs(6, seed=2)
    losses = []
    for _ in range(TOY_STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return np.array(losses)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"pp{m[0]}dp{m[1]}")
def test_pipeline_train_step_matches_jax(world, mesh):
    """make_pipeline_train_step (Adam without weight decay) over 5 steps:
    the losses equal JAX's, stacked and over the world, and fall."""
    want = _jax_toy_losses(mesh)
    for r in range(4):
        np.testing.assert_allclose(world[r][f"toy-{mesh[0]}x{mesh[1]}"],
                                   want, rtol=1e-5)
    step, _ = tpl.make_pipeline_train_step(tpl.StackedPipe(mesh[0]), D, FF,
                                           device="cpu")
    params = stage_params_from_jax(_tree(mesh[0]), device="cpu")
    from elastic_tpu_agent_torch.workloads.transformer import AdamW

    state = AdamW(1e-2, weight_decay=0.0).init(params)
    x, y = _inputs(6, seed=2)
    got = [float(step(params, state, x, y)[2]) for _ in range(TOY_STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_pipeline_mesh_checks(tmp_path):
    """make_pipeline_mesh's process model: no process group raises; a
    one-rank world gives dims ("pp", "dp") and refuses pp * dp != 1."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="init_process_group"):
        tpl.make_pipeline_mesh(1, device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = tpl.make_pipeline_mesh(1, device_type="cpu")
        assert mesh.mesh_dim_names == ("pp", "dp")
        with pytest.raises(ValueError, match="n_devices 2 != world size 1"):
            tpl.make_pipeline_mesh(2, device_type="cpu")
        with pytest.raises(ValueError, match="needs the nccl backend"):
            tpl.make_pipeline_mesh(1)
    finally:
        dist.destroy_process_group()
