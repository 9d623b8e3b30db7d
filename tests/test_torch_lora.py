"""LoRA of the PyTorch port (elastic_tpu_agent_torch/workloads/lora.py)
against the JAX package: the adapter tree crosses the weight bridge,
apply_lora/merge_lora equal JAX's, and 5 train steps (the port through
its flash kernels' plain versions, JAX through reference attention, as
tests/test_lora.py runs it) give losses and adapters within 1e-5; the
base stays bit-unchanged and the optimizer state covers the adapters
only. float32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import lora as jlora  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import lora as tlora  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    lora_from_jax,
    params_from_jax,
    params_to_jax,
)

# head_dim 64: the port's forward takes the flash path (its plain version
# on the CPU)
BASE = dict(vocab=97, d_model=128, n_heads=2, n_layers=2, d_ff=64,
            max_seq=64)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _models(**kw):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, attn="flash", **kw)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=1, pos="rope")],
                         ids=["mha", "gqa-rope"])
def test_apply_and_merge_equal_jax(kw):
    jcfg, tcfg, tree, params = _models(**kw)
    jl = jlora.init_lora_params(tree, jax.random.key(1), rank=4,
                                targets=("wqkv", "wq", "wkv", "wo", "w1"))
    # a nonzero B, so that the delta is not zero
    jl = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.key(2), x.shape),
        jax.device_get(jl))
    tl = lora_from_jax(jax.device_get(jl), tcfg, device="cpu")
    assert tlora.lora_param_count(tl) == jlora.lora_param_count(jl)
    names = {"wq", "wkv", "wo", "w1"} if kw else {"wqkv", "wo", "w1"}
    assert all(set(e) == names for e in tl["layers"])
    want = jax.device_get(jlora.merge_lora(tree, jl, scale=0.5))
    got = params_to_jax(tlora.merge_lora(params, tl, scale=0.5))
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    assert params_to_jax(tl)["layers"][0]["wo"]["a"].shape == (128, 4)


def test_bridge_rejects_a_mismatched_adapter_tree():
    _, tcfg, tree, _ = _models()
    jl = jax.device_get(jlora.init_lora_params(tree, jax.random.key(1)))
    bad = {"layers": [dict(e) for e in jl["layers"]]}
    bad["layers"][0]["wo"] = {"a": jl["layers"][0]["wo"]["a"][:7],
                              "b": jl["layers"][0]["wo"]["b"]}
    with pytest.raises(ValueError, match="layers/0/wo"):
        lora_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="layers/1/ln1_scale"):
        lora_from_jax({"layers": [{}, {"ln1_scale": {}}]}, tcfg,
                      device="cpu")


def test_zero_init_is_the_base_and_targets_are_checked():
    _, tcfg, _, params = _models()
    lora = tlora.init_lora_params(params, torch.Generator().manual_seed(1),
                                  rank=4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 97, (2, 10)))
    torch.testing.assert_close(
        tt.forward(tlora.apply_lora(params, lora), toks, tcfg, device="cpu"),
        tt.forward(params, toks, tcfg, device="cpu"), atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.init_lora_params(params, torch.Generator(), targets=("wx",),
                               device="cpu")
    with pytest.raises(ValueError, match="matched any layer"):
        tlora.init_lora_params(params, torch.Generator(), targets=("wq",),
                               device="cpu")


def test_train_steps_match_jax_and_leave_the_base():
    """5 steps on one batch from the JAX init's adapters: losses within
    1e-5 relative, adapters within 1e-5; the base bit-unchanged and
    without grad; optimizer moments shaped like the adapters alone."""
    jcfg, tcfg, tree, params = _models()
    lr, steps = 1e-3, 5
    jstep, jinit = jlora.make_lora_train_step(jcfg, rank=4,
                                              learning_rate=lr)
    jl, jopt = jinit(tree, jax.random.key(1))
    tstep, tinit = tlora.make_lora_train_step(tcfg, rank=4,
                                              learning_rate=lr, device="cpu")
    own, topt = tinit(params)
    assert all(not ab["b"].any() for e in own["layers"] for ab in e.values())
    # the JAX init's adapters, so that both runs start from one point
    tl = lora_from_jax(jax.device_get(jl), tcfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, 97, size=(2, 17))
    before = [p.clone() for p in tt._leaves(params)]
    jlosses, tlosses = [], []
    for _ in range(steps):
        jl, jopt, jloss = jstep(tree, jl, jopt, jnp.asarray(tokens))
        tl, topt, tloss = tstep(params, tl, topt, tokens)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    for g, w in zip(_leaves(params_to_jax(tl)), _leaves(jax.device_get(jl))):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    for p, b in zip(tt._leaves(params), before):
        assert not p.requires_grad and torch.equal(p, b)
    assert int(topt["count"]) == steps
    shapes = [tuple(t.shape) for t in tt._leaves(tl)]
    assert [tuple(t.shape) for t in tt._leaves(topt["mu"])] == shapes
    assert [tuple(t.shape) for t in tt._leaves(topt["nu"])] == shapes
    assert sum(t.numel() for t in tt._leaves(topt["mu"])) == (
        tlora.lora_param_count(tl))
