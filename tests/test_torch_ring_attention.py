"""The port's ring attention against JAX ``ring_attention_sharded`` on a
(1, 4, 1) mesh, on the CPU: over 4 ranks of a spawned gloo world
(``torch_worlds.py``; every leg once, in a module fixture) and with the
stacked exchange in this process.

Causal and non-causal, at head dim 128 (the chunk passes the flash gate
on both sides: JAX's interpret-mode Pallas kernels, the port's kernels'
plain versions) and at head dim 16 (both sides' einsum fallback).
Tolerances are JAX's own in ``tests/test_attention.py``: outputs 2e-5,
gradients of sum(o * w) 5e-5, absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import ring_attention as jra  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import ring_attention as ra  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402

import torch_worlds  # noqa: E402

SP = 4
SHAPES = {"h128": (1, 512, 2, 128), "h16": (2, 64, 4, 16)}
CASES = [(h, c) for h in SHAPES for c in (True, False)]


def _case_id(case):
    return f"{case[0]}-{'causal' if case[1] else 'noncausal'}"


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return {x: rng.normal(size=shape).astype(np.float32)
            for x in ("q", "k", "v", "w")}


LEGS = {_case_id(c): dict(causal=c[1], **_inputs(SHAPES[c[0]], i))
        for i, c in enumerate(CASES)}


@pytest.fixture(scope="module")
def world():
    spec = {"legs": [dict(name=n, **leg) for n, leg in LEGS.items()]}
    return torch_worlds.run_world(torch_worlds.ring_legs, SP, spec)


_JAX = {}


def _jax(name):
    """JAX's output and gradients for a leg (computed once a leg: the
    ranks' and the stacked test share them)."""
    if name not in _JAX:
        _JAX[name] = _jax_ring(LEGS[name])
    return _JAX[name]


def _jax_ring(leg):
    mesh = jt.make_mesh(SP, dp=1, sp=SP, tp=1)

    def obj(q, k, v):
        o = jra.ring_attention_sharded(q, k, v, mesh, causal=leg["causal"])
        return jnp.sum(o * leg["w"]), o

    (_, o), grads = jax.value_and_grad(obj, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(leg[x]) for x in ("q", "k", "v")))
    return [np.asarray(x) for x in (o, *grads)]


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ring_over_ranks_matches_jax(world, case):
    """sp 4 over 4 ranks (batch_isend_irecv): each rank's output and
    gradient chunks, put together, equal JAX's."""
    name = _case_id(case)
    got = [np.concatenate([world[r][name][i] for r in range(SP)], axis=1)
           for i in range(4)]
    _check(got, _jax(name))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_stacked_ring_matches_jax(case):
    """The same schedule with all 4 chunks in this process (a roll of the
    leading axis)."""
    name = _case_id(case)
    leg = LEGS[name]
    q, k, v = (torch.from_numpy(leg[x]).requires_grad_()
               for x in ("q", "k", "v"))
    o = ra.ring_attention_stacked(q, k, v, SP, causal=leg["causal"])
    grads = torch.autograd.grad((o * torch.from_numpy(leg["w"])).sum(),
                                (q, k, v))
    _check([o.detach().numpy()] + [g.numpy() for g in grads], _jax(name))


def test_auto_picks_the_ring_under_sp(world):
    """attn="auto" with a mesh of sp 4 runs the ring (one call), and its
    output is the ring's."""
    name = _case_id(CASES[0])
    for r in range(SP):
        assert world[r]["auto"]["calls"] == 1
        np.testing.assert_array_equal(world[r]["auto"]["o"], world[r][name][0])


def test_ring_refusals_match_jax():
    """A sliding window with the ring raises, and so does the ring without
    a mesh, with JAX's messages; ModelConfig(attn="ring") is accepted."""
    q = np.zeros((1, 8, 2, 16), np.float32)
    base = dict(vocab=8, d_model=32, n_heads=2, n_layers=1, d_ff=8)
    for kw, msg in ((dict(window=4), "sliding-window"), ({}, "needs a mesh")):
        with pytest.raises(ValueError, match=msg):
            tt._attention_core(*(torch.from_numpy(q),) * 3,
                               tt.ModelConfig(**base, attn="ring", **kw))
        with pytest.raises(ValueError, match=msg):
            jt._attention_core(*(jnp.asarray(q),) * 3,
                               jt.ModelConfig(**base, attn="ring", **kw),
                               None)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_stacked_ring_rotates_grouped_kv(causal):
    """k/v at 2 kv heads for 4 query heads rotate at their own width: the
    output and q gradient equal the ring over repeated heads, and the kv
    gradients are the repeated ones' group sums."""
    leg = _inputs((2, 64, 4, 64), 11)
    q = torch.from_numpy(leg["q"]).requires_grad_()
    k, v = (torch.from_numpy(leg[x][:, :, :2]).requires_grad_()
            for x in ("k", "v"))
    w = torch.from_numpy(leg["w"])
    o = ra.ring_attention_stacked(q, k, v, SP, causal=causal)
    g = torch.autograd.grad((o * w).sum(), (q, k, v))
    kr, vr = (x.detach().repeat_interleave(2, dim=2).requires_grad_()
              for x in (k, v))
    q2 = q.detach().requires_grad_()
    o2 = ra.ring_attention_stacked(q2, kr, vr, SP, causal=causal)
    g2 = torch.autograd.grad((o2 * w).sum(), (q2, kr, vr))
    torch.testing.assert_close(o, o2, atol=1e-6, rtol=0)
    torch.testing.assert_close(g[0], g2[0], atol=1e-6, rtol=0)
    for a, b in zip(g[1:], g2[1:]):
        torch.testing.assert_close(a, b.reshape(2, 64, 2, 2, 64).sum(3),
                                   atol=1e-5, rtol=0)
