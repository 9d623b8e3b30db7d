"""The PyTorch port's int8 quantization (elastic_tpu_agent_torch/workloads/
quantize.py) against the JAX package on the same trees, on the CPU.

Tolerance: none. Quantized trees, dequantized trees, KV quantization and
byte counts must be byte-equal to JAX's: both divide by the same f32
scale, round half to even and clip to +-127. The bridge carries an int8
tree both ways unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elastic_tpu_agent.workloads import quantize as jq  # noqa: E402
from elastic_tpu_agent.workloads import transformer as jt  # noqa: E402
from elastic_tpu_agent_torch.workloads import quantize as tq  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402
from elastic_tpu_agent_torch.workloads.weights import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)

BASE = dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=96)
CASES = [dict(), dict(n_kv_heads=2, pos="rope"), dict(moe_experts=4)]
IDS = ["mha", "gqa-rope", "moe"]


def _flat(tree, path=""):
    """{path: numpy array} over a params tree, int8 leaves split into
    their q and s."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{name}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    if torch.is_tensor(tree):
        tree = tree.numpy()
    return {path: np.asarray(tree)}


def _assert_bytes_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _trees(kw, seed=0):
    jcfg = jt.ModelConfig(**BASE, dtype=jnp.float32, attn="reference", **kw)
    tcfg = tt.ModelConfig(**BASE, dtype=torch.float32, **kw)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.key(seed)))
    return jcfg, tcfg, tree


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_quantize_params_byte_equal(kw):
    """quantize_params, dequantize_params and quantized_bytes on a JAX
    init_params tree (MoE expert stacks included, the router left f32)."""
    _, tcfg, tree = _trees(kw)
    want = jax.device_get(jq.quantize_params(tree))
    params = params_from_jax(tree, tcfg, device="cpu")
    got = tq.quantize_params(params)
    _assert_bytes_equal(got, want)
    if "moe_experts" in kw:
        moe = got["layers"][1]["moe"]
        assert tq.is_quantized(moe["w1"]) and tq.is_quantized(moe["w2"])
        assert torch.equal(moe["wg"], params["layers"][1]["moe"]["wg"])
    assert tq.is_quantized(got["embed"]) and not tq.is_quantized(
        got["final_norm_scale"])
    assert tq.quantized_bytes(got) == jq.quantized_bytes(want)
    assert tq.quantized_bytes(params) == jq.quantized_bytes(tree)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        deq = tq.dequantize_params(got, dtype)
        jdeq = jax.device_get(jq.dequantize_params(want, jdtype))
        if dtype == torch.bfloat16:   # numpy holds no bf16: compare as f32
            deq = tq._tree_map(lambda path, t: t.float(), deq)
            jdeq = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), jdeq)
        _assert_bytes_equal(deq, jdeq)


def test_quantize_weight_rounding_edges():
    """Ties round to even, an all-zero channel keeps scale 1e-8/127 and
    q 0, and values clip at +-127."""
    w = np.array([[0.5, -1.5, 2.5, 127.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [63.5, -63.5, 127.0, -127.0]], np.float32).T
    want = jax.device_get(jq.quantize_weight(jnp.asarray(w), (1,)))
    got = tq.quantize_weight(torch.from_numpy(w), (1,))
    _assert_bytes_equal(got, want)
    assert got["q"][:, 1].abs().max() == 0


@pytest.mark.parametrize("shape", [(3, 5, 2, 8), (1, 16)])
def test_quantize_kv_byte_equal(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    x[0] = 0.0                          # an all-zero position
    want = jax.device_get(jq.quantize_kv(jnp.asarray(x)))
    got = tq.quantize_kv(torch.from_numpy(x))
    _assert_bytes_equal(got, want)
    assert got["s"].shape == shape[:-1] + (1,)
    _assert_bytes_equal(tq.dequantize_kv(got),
                        jax.device_get(jq.dequantize_kv(want)))


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_bridge_round_trips_an_int8_tree(kw):
    """A JAX int8 tree crosses into the port and back unchanged, and the
    port's wdense/embed_lookup read it as JAX's do."""
    _, tcfg, tree = _trees(kw, seed=2)
    qtree = jax.device_get(jq.quantize_params(tree))
    params = params_from_jax(qtree, tcfg, device="cpu")
    wo = params["layers"][0]["wo"]
    assert wo["q"].dtype == torch.int8 and wo["s"].dtype == torch.float32
    _assert_bytes_equal(params_to_jax(params), qtree)
    got = tq.wdense(params["layers"][0], "wo", torch.float32)
    want = jq.wdense(qtree["layers"][0], "wo", jnp.float32)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    tokens = np.array([[0, 5, 96], [7, 7, 1]])
    got = tq.embed_lookup(params, torch.from_numpy(tokens), torch.float32)
    want = jq.embed_lookup(qtree, jnp.asarray(tokens), jnp.float32)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    bad = dict(qtree, lm_head={"q": qtree["lm_head"]["q"].astype(np.int16),
                               "s": qtree["lm_head"]["s"]})
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, tcfg, device="cpu")
