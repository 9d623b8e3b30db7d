"""Weight-only int8 quantization for the decode path, PyTorch port.

Counterpart of ``elastic_tpu_agent/workloads/quantize.py``: symmetric
per-output-channel int8 with an f32 scale (no zero point), each selected
weight leaf replaced by ``{"q": int8, "s": f32}``; the token embedding is
quantized per row. ``wdense`` and ``embed_lookup`` resolve either form,
so the forward code serves both trees. The trees are byte-equal to the
JAX package's: the same f32 division by the scale (never a reciprocal's
product), the same half-to-even rounding (``torch.round`` rounds so on
the CPU and on CUDA, as ``jnp.round`` does) and clip to +-127.

The int8 KV pool's per-position form (``quantize_kv``) is the serving
engine's ``kv_int8`` storage.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

# Leaf names eligible for quantization, with the axis index (or indices)
# of the OUTPUT features in that weight's einsum. Everything else (norm
# scales, pos_embed) stays float.
#   wqkv [d, 3, n, h] -> out axes (1, 2, 3)
#   wq   [d, n, h]    -> out axes (1, 2)
#   wkv  [d, 2, g, h] -> out axes (1, 2, 3)
#   wo   [n, h, d]    -> out axis 2
#   w1   [d, f]       -> out axis 1
#   w2   [f, d]       -> out axis 1
#   lm_head [d, v]    -> out axis 1
#   embed [v, d]      -> per-row (axis 0 is the gather axis)
_OUT_AXES = {
    "wqkv": (1, 2, 3),
    "wq": (1, 2),
    "wkv": (1, 2, 3),
    "wo": (2,),
    "w1": (1,),
    "w2": (1,),
    "lm_head": (1,),
    "embed": (0,),
}

# The MoE subtree's 3-D expert stacks. The router ``wg`` stays float: its
# argmax decides expert assignment, and quantization noise there would
# flip routes rather than perturb activations smoothly.
#   w1 [E, d, f] -> per (expert, out-col)
#   w2 [E, f, d] -> per (expert, out-col)
_MOE_OUT_AXES = {
    "w1": (0, 2),
    "w2": (0, 2),
}


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127 by a true f32 division: on CUDA a tensor
    divided by a Python number is multiplied by its reciprocal, which can
    land one ulp away, so the divisor is a tensor."""
    return torch.clamp(absmax, min=1e-8) / absmax.new_tensor(127.0)


def quantize_weight(w: torch.Tensor, out_axes) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over the non-out axes; scale shaped to out axes."""
    w = w.float()
    reduce_axes = tuple(a for a in range(w.dim()) if a not in out_axes)
    scale = _scale(torch.amax(w.abs(), dim=reduce_axes, keepdim=True))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_weight(qw: Dict[str, torch.Tensor], dtype=torch.bfloat16):
    """int8 + scale -> dtype (the product in f32, then one rounding)."""
    return (qw["q"].float() * qw["s"]).to(dtype)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _tree_map(fn: Callable, tree, path: Tuple = ()):
    """Map fn(path, leaf) over nested dicts/lists; anything else, and an
    int8 ``{"q", "s"}`` leaf, is a leaf (so a shape tuple is one)."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def wdense(container: Dict, name: str, dtype=torch.bfloat16) -> torch.Tensor:
    """A weight in ``dtype`` from either a float or a quantized tree (a
    no-op for a float leaf stored in it)."""
    leaf = container[name]
    if is_quantized(leaf):
        return dequantize_weight(leaf, dtype)
    return leaf.to(dtype)


def embed_lookup(params: Dict, tokens: torch.Tensor, dtype=torch.bfloat16):
    """Token-embedding gather for either form. Quantized: gather the int8
    rows and their per-row scales, multiply after the gather (exact
    per-row dequantization; the read stays int8-sized)."""
    leaf = params["embed"]
    if is_quantized(leaf):
        rows = leaf["q"][tokens].float()
        return (rows * leaf["s"][tokens]).to(dtype)
    return leaf.to(dtype)[tokens]


def quantize_kv(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int8 of K/V cache entries with one f32 scale per
    POSITION (amax over the trailing head_dim axis): ``{"q": int8
    [..., h], "s": f32 [..., 1]}``."""
    x = x.float()
    scale = _scale(torch.amax(x.abs(), dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize_kv(qkv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inverse of quantize_kv (f32 out; exact per-position dequant)."""
    return qkv["q"].float() * qkv["s"]


def quantize_params(params: Dict) -> Dict:
    """Quantize every eligible leaf of a transformer params tree (the
    ``init_params`` layout, MoE layers included). Returns a new tree; the
    input is not modified."""

    def qleaf(name: str, leaf, axes_table):
        axes = axes_table.get(name)
        if axes is None or not torch.is_tensor(leaf):
            return leaf
        return quantize_weight(leaf, axes)

    def qlayer(layer: Dict) -> Dict:
        out = {k: qleaf(k, v, _OUT_AXES) for k, v in layer.items()}
        if "moe" in layer:
            out["moe"] = {
                k: qleaf(k, v, _MOE_OUT_AXES)
                for k, v in layer["moe"].items()
            }
        return out

    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "layers":
            out["layers"] = [qlayer(layer) for layer in leaf]
        else:
            out[name] = qleaf(name, leaf, _OUT_AXES)
    return out


def dequantize_params(qparams: Dict, dtype=torch.float32) -> Dict:
    """Inverse of quantize_params for any tree shape: every quantized
    leaf back to ``dtype``, everything else passed through."""
    return _tree_map(
        lambda path, leaf: (
            dequantize_weight(leaf, dtype) if is_quantized(leaf) else leaf
        ),
        qparams,
    )


def quantized_bytes(params: Dict) -> int:
    """Total parameter bytes as stored (int8 leaves count 1 B each plus
    their f32 scales)."""
    total = 0

    def add(path, leaf):
        nonlocal total
        for t in leaf.values() if is_quantized(leaf) else (leaf,):
            total += t.numel() * t.element_size()

    _tree_map(add, params)
    return total
