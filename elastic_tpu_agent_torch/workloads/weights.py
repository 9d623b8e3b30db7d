"""Weight bridge between the JAX package's parameter tree and the port's.

``params_from_jax`` takes the tree ``elastic_tpu_agent.workloads.
transformer.init_params`` builds (numpy arrays, or anything ``np.asarray``
takes) and returns the port's params: the same keys and the same axis
layout (``wqkv [d,3,n,h]``, ``wq [d,n,h]``, ``wkv [d,2,g,h]``, ``wo [n,h,d]``,
``w1``, ``w2``, ``embed``, ``pos_embed``, ``lm_head``, the norm scales and
an MoE layer's ``moe.{wg [d,E], w1 [E,d,ff], w2 [E,ff,d]}``) as torch
tensors. ``params_to_jax`` goes back to numpy. An int8 tree
(``quantize.quantize_params``, either package's) crosses both ways with
each ``{"q", "s"}`` leaf kept as it is: int8 values and f32 scales.

Leaves are stored in the dtype the caller asks for, ``cfg.dtype`` by
default. The JAX code casts each leaf to ``cfg.dtype`` at every use
(``.astype(cfg.dtype)``, ``wdense``), so for serving, casting once at load
gives the same numbers the JAX forward computes with. The JAX train step
stores f32 leaves and updates them in f32 (or, under ``master_weights``,
``cfg.dtype`` live leaves beside f32 masters): load with
``dtype=torch.float32`` to train as it does. The MoE router ``wg`` is the
exception: the JAX router reads it in f32 whatever ``cfg.dtype`` is, so it
is stored in f32 at least.

This module imports neither JAX nor the JAX package: the tree is plain
data, checked against the shapes ``jax_layout_shapes`` derives from the
config.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .quantize import _tree_map, is_quantized


def jax_layout_shapes(cfg) -> Dict:
    """The JAX ``init_params`` tree for ``cfg`` with each leaf replaced by
    its shape (an MoE layer holds a ``moe`` subtree instead of w1/w2)."""
    d, n, g, h = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    if cfg.is_gqa and n % g:
        raise ValueError(f"n_heads {n} must be a multiple of n_kv_heads {g}")
    if cfg.pos == "rope" and h % 2:
        raise ValueError("rope needs an even head_dim")
    tree: Dict[str, Any] = {
        "embed": (cfg.vocab, d),
        "final_norm_scale": (d,),
        "lm_head": (d, cfg.vocab),
        "layers": [],
    }
    if cfg.pos == "learned":
        tree["pos_embed"] = (cfg.max_seq, d)
    e = cfg.moe_experts
    for i in range(cfg.n_layers):
        layer = {"ln1_scale": (d,), "wo": (n, h, d), "ln2_scale": (d,)}
        if cfg.is_moe_layer(i):
            layer["moe"] = {
                "wg": (d, e), "w1": (e, d, cfg.d_ff), "w2": (e, cfg.d_ff, d),
            }
        else:
            layer["w1"] = (d, cfg.d_ff)
            layer["w2"] = (cfg.d_ff, d)
        if cfg.is_gqa:
            layer["wq"] = (d, n, h)
            layer["wkv"] = (d, 2, g, h)
        else:
            layer["wqkv"] = (d, 3, n, h)
        tree["layers"].append(layer)
    return tree


def _keys(tree, path=()):
    if isinstance(tree, dict) and not is_quantized(tree):
        out = set()
        for k, v in tree.items():
            out |= _keys(v, path + (k,))
        return out
    if isinstance(tree, list):
        out = {path + ("#len", len(tree))}
        for i, v in enumerate(tree):
            out |= _keys(v, path + (i,))
        return out
    return {path}


def params_from_jax(tree: Dict, cfg, device="cuda", dtype=None) -> Dict:
    """JAX-layout tree -> the port's params (float tensors in ``dtype``,
    default cfg.dtype, the router ``wg`` in f32 at least; int8 leaves as
    int8 and f32 tensors) on ``device``. Raises on any key or shape that
    ``cfg`` does not give."""
    shapes = jax_layout_shapes(cfg)
    if _keys(tree) != _keys(shapes):
        raise ValueError(
            "params tree does not match the config's layout: "
            f"missing {sorted(map(str, _keys(shapes) - _keys(tree)))[:4]}, "
            f"unexpected {sorted(map(str, _keys(tree) - _keys(shapes)))[:4]}"
        )

    float_dtype = dtype or cfg.dtype

    def leaf(path, x):
        name = "/".join(map(str, path))
        want = tuple(_lookup(shapes, path))
        if is_quantized(x):
            q, s = np.asarray(x["q"]), np.asarray(x["s"])
            if q.shape != want or q.dtype != np.int8 or q.ndim != s.ndim:
                raise ValueError(
                    f"{name}: int8 leaf q {q.dtype}{q.shape}, s {s.shape}; "
                    f"config gives {want}"
                )
            return {
                "q": torch.from_numpy(np.array(q, order="C")).to(device),
                "s": torch.from_numpy(
                    np.array(s, np.float32, order="C")).to(device),
            }
        a = np.asarray(x)
        if a.shape != want:
            raise ValueError(f"{name}: shape {a.shape}, config gives {want}")
        if a.dtype.kind != "f" or a.dtype.itemsize not in (4, 8):
            a = a.astype(np.float32)  # bf16/f16 widen exactly
        to = float_dtype
        if path[-1] == "wg":        # the router: f32 in the JAX code
            to = torch.promote_types(to, torch.float32)
        return torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=to
        )

    return _tree_map(leaf, tree)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def params_to_jax(params: Dict) -> Dict:
    """The port's params -> a JAX-layout tree of numpy arrays (float32
    for bfloat16 leaves, which numpy cannot hold; the widening is exact;
    an int8 leaf stays ``{"q": int8, "s": f32}``)."""
    def leaf(path, t):
        if is_quantized(t):
            return {k: v.detach().cpu().numpy() for k, v in t.items()}
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _tree_map(leaf, params)


def random_tree(cfg, seed: int = 0) -> Dict:
    """A JAX-layout numpy tree drawn like ``init_params`` draws it
    (normal(0.02) weights in f32, unit norm scales), from a numpy seed.
    Not the JAX values: ``jax.random`` streams are not numpy's."""
    rng = np.random.default_rng(seed)
    return _tree_map(
        lambda path, shape: (
            np.ones(shape, np.float32) if path[-1].endswith("_scale")
            else (rng.standard_normal(shape, np.float32) * 0.02)
        ),
        jax_layout_shapes(cfg),
    )
