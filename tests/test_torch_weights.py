"""Weight bridge of the PyTorch port (elastic_tpu_agent_torch/workloads/
weights.py): a JAX init_params tree goes to torch and back unchanged."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    jax_layout_shapes,
    params_from_jax,
    params_to_jax,
    random_tree,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)


def _cfgs(dtype_j, dtype_t, **kw):
    return (
        jt.ModelConfig(**BASE, dtype=dtype_j, **kw),
        tt.ModelConfig(**BASE, dtype=dtype_t, **kw),
    )


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize(
    "kw", [dict(), dict(n_kv_heads=2), dict(pos="rope"), dict(moe_experts=4)],
    ids=["mha", "gqa", "rope", "moe"],
)
def test_round_trip_f32_bit_equal(kw):
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32, **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.key(0))
    )
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["layers"][0]["wo"].shape == (4, 8, 32)
    back = params_to_jax(params)
    got, want = _leaves(back), _leaves(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_round_trip_bf16_is_the_jax_cast():
    """Stored in cfg.dtype once at load: each leaf equals the JAX code's
    own .astype(bfloat16) of it, bit for bit."""
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    tree = jt.init_params(jcfg, jax.random.key(1))
    params = params_from_jax(tree, tcfg, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    for (path, a), (_, b) in zip(
        _leaves(params_to_jax(params)), _leaves(tree)
    ):
        want = np.asarray(b.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(a, want, err_msg=str(path))


def test_moe_router_and_int8_leaves_keep_their_dtypes():
    """At a bf16 config the MoE router stays f32 (the JAX router reads
    it in f32) while the expert stacks take bf16; an int8 tree keeps its
    int8 values and f32 scales whatever the config's dtype."""
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16, moe_experts=4)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(2)))
    moe = params_from_jax(tree, tcfg, device="cpu")["layers"][1]["moe"]
    assert moe["wg"].dtype == torch.float32
    assert moe["w1"].dtype == moe["w2"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["wg"].numpy(),
                                  tree["layers"][1]["moe"]["wg"])
    qtree = jax.device_get(jq.quantize_params(tree))
    qmoe = params_from_jax(qtree, tcfg, device="cpu")["layers"][1]["moe"]
    assert qmoe["w1"]["q"].dtype == torch.int8
    assert qmoe["w1"]["s"].dtype == torch.float32
    np.testing.assert_array_equal(qmoe["w1"]["q"].numpy(),
                                  qtree["layers"][1]["moe"]["w1"]["q"])


def test_layout_mismatch_rejected():
    _, tcfg = _cfgs(jnp.float32, torch.float32)
    tree = random_tree(tcfg, 0)
    tree["layers"][1]["wo"] = np.zeros((4, 8, 16), np.float32)
    with pytest.raises(ValueError, match="wo"):
        params_from_jax(tree, tcfg, device="cpu")
    gqa = tt.ModelConfig(**BASE, dtype=torch.float32, n_kv_heads=2)
    with pytest.raises(ValueError, match="layout"):
        params_from_jax(random_tree(tcfg, 0), gqa, device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(n_kv_heads=2, pos="rope"),
                                dict(moe_experts=4, moe_every=1)])
def test_random_tree_and_init_params_follow_jax_layout(kw):
    jcfg, tcfg = _cfgs(jnp.float32, torch.float32, **kw)
    jtree = jt.init_params(jcfg, jax.random.key(0))
    shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), jtree
    )
    assert shapes == jax_layout_shapes(tcfg)
    tree = random_tree(tcfg, 3)
    assert jax.tree_util.tree_map(lambda x: x.shape, tree) == shapes
    g = torch.Generator().manual_seed(0)
    params = tt.init_params(tcfg, g, device="cpu")
    assert jax.tree_util.tree_map(
        lambda x: tuple(x.shape), params_to_jax(params)
    ) == shapes
    assert float(params["layers"][0]["ln1_scale"].min()) == 1.0


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_pipeline_restack_round_trip_is_bit_exact(pp):
    """A flat init_params tree restacked into the pipelined layout holds
    JAX init_pipeline_params' keys and shapes, loads through
    pipeline_params_from_jax, and unstacks to the same tree bit for bit
    (numpy and torch leaves)."""
    from elastic_tpu_agent.workloads import transformer_pipeline as jtp
    from elastic_tpu_agent_torch.workloads.weights import (
        pipeline_params_from_jax,
        restack_for_pipeline,
        unstack_pipeline,
    )

    kw = dict(BASE, n_layers=4)
    jcfg = jt.ModelConfig(**kw, dtype=jnp.float32)
    tcfg = tt.ModelConfig(**kw, dtype=torch.float32)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(3)))
    stacked = restack_for_pipeline(tree, tcfg, pp)
    ref = jax.eval_shape(lambda: jtp.init_pipeline_params(
        jcfg, jax.random.key(0), pp))
    assert jax.tree.map(np.shape, stacked) == jax.tree.map(
        lambda a: a.shape, ref)
    np.testing.assert_array_equal(stacked["stages"]["wqkv"][pp - 1, -1],
                                  tree["layers"][-1]["wqkv"])
    for got, want in zip(_leaves(unstack_pipeline(stacked, tcfg)),
                         _leaves(tree)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    params = pipeline_params_from_jax(stacked, tcfg, pp, device="cpu")
    back = params_to_jax(unstack_pipeline(params, tcfg))
    for got, want in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(got[1], want[1])
    torch_back = restack_for_pipeline(params_from_jax(tree, tcfg,
                                                      device="cpu"), tcfg, pp)
    for k, v in torch_back["stages"].items():
        assert torch.equal(v, params["stages"][k])
