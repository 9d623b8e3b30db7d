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
``lora_from_jax`` loads a LoRA adapter tree (``lora.init_lora_params``,
``{"layers": [{name: {"a": [in, r], "b": [r, out]}}]}``) in f32;
``params_to_jax`` takes it back.

The pipelined layout (JAX ``init_pipeline_params``) stacks the layer
leaves ``[pp, L/pp, ...]`` under ``stages`` (``wqkv [pp, L/pp, d, 3, n,
h]``, ``wo [pp, L/pp, n, h, d]``, ...) beside the unstacked ``embed``,
``pos_embed``, ``final_norm_scale`` and ``lm_head``:
``pipeline_params_from_jax`` loads it, ``stage_params_from_jax`` the toy
block stack of JAX ``init_stage_params`` (``w1 [pp, d, ff]``, ``w2 [pp,
ff, d]``). ``restack_for_pipeline`` and ``unstack_pipeline`` turn a flat
``init_params`` tree into that layout and back, a change of layout only,
so the same weights run pipelined and not.

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
    _check_keys(tree, shapes)
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
        to = float_dtype
        if path[-1] == "wg":        # the router: f32 in the JAX code
            to = torch.promote_types(to, torch.float32)
        return _float_leaf(name, x, want, device, to)

    return _tree_map(leaf, tree)


def _check_keys(tree: Dict, shapes: Dict) -> None:
    if _keys(tree) != _keys(shapes):
        raise ValueError(
            "params tree does not match the config's layout: "
            f"missing {sorted(map(str, _keys(shapes) - _keys(tree)))[:4]}, "
            f"unexpected {sorted(map(str, _keys(tree) - _keys(shapes)))[:4]}"
        )


def _float_leaf(name: str, x, want, device, dtype) -> torch.Tensor:
    """A float array as a tensor in ``dtype`` on ``device``, after its
    shape is checked against ``want``."""
    a = np.asarray(x)
    if a.shape != want:
        raise ValueError(f"{name}: shape {a.shape}, config gives {want}")
    if a.dtype.kind != "f" or a.dtype.itemsize not in (4, 8):
        a = a.astype(np.float32)  # bf16/f16 widen exactly
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                       dtype=dtype)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def lora_from_jax(tree: Dict, cfg, device="cuda") -> Dict:
    """A JAX LoRA adapter tree -> the port's adapters: f32 tensors on
    ``device``, the same structure. Raises where a layer's entry names a
    weight that ``cfg``'s layer lacks or that LoRA does not adapt, or where
    a factor's shape is not that weight's [in, r] / [r, out] split."""
    from .lora import _IN_AXES, _in_out

    layers = jax_layout_shapes(cfg)["layers"]
    if set(tree) != {"layers"} or len(tree["layers"]) != len(layers):
        raise ValueError(
            f"adapter tree wants {{'layers': [{len(layers)} entries]}}"
        )
    out = []
    for i, (entry, shapes) in enumerate(zip(tree["layers"], layers)):
        conv = {}
        for name in entry:
            if name not in _IN_AXES or name not in shapes:
                raise ValueError(f"layers/{i}/{name}: not an adapted weight")
        # init_lora_params' order (_IN_AXES), which the optimizer's state
        # pairs leaves by
        for name in (n for n in _IN_AXES if n in entry):
            ab = entry[name]
            d_in, d_out = _in_out(shapes[name], _IN_AXES[name])
            if set(ab) != {"a", "b"}:
                raise ValueError(f"layers/{i}/{name}: keys {sorted(ab)}")
            a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
            if (a.ndim != 2 or a.shape[0] != d_in
                    or b.shape != (a.shape[1], d_out)):
                raise ValueError(
                    f"layers/{i}/{name}: a {a.shape}, b {b.shape}; the "
                    f"weight splits [{d_in}, r] @ [r, {d_out}]"
                )
            conv[name] = {
                k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in (("a", a), ("b", b))
            }
        out.append(conv)
    return {"layers": out}


def params_to_jax(params: Dict) -> Dict:
    """The port's params (or LoRA adapters) -> a JAX-layout tree of numpy
    arrays (float32 for bfloat16 leaves, which numpy cannot hold; the
    widening is exact; an int8 leaf stays ``{"q": int8, "s": f32}``)."""
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


# -- the pipelined layout ----------------------------------------------------

_STAGE_KEYS = ("ln1_scale", "wqkv", "wo", "ln2_scale", "w1", "w2")


def pipeline_layout_shapes(cfg, pp: int) -> Dict:
    """The JAX ``init_pipeline_params`` tree for ``cfg`` at ``pp`` stages,
    each leaf replaced by its shape (JAX's config checks first)."""
    from .transformer_pipeline import check_pipeline_config

    check_pipeline_config(cfg, pp)
    flat = jax_layout_shapes(cfg)
    layer = flat["layers"][0]
    lpp = cfg.n_layers // pp
    out = {k: v for k, v in flat.items() if k != "layers"}
    out["stages"] = {k: (pp, lpp, *layer[k]) for k in _STAGE_KEYS}
    return out


def restack_for_pipeline(tree: Dict, cfg, pp: int) -> Dict:
    """A flat ``init_params`` tree (numpy or torch leaves) in the pipelined
    layout: layer i lands at ``stages[k][i // (L/pp), i % (L/pp)]``."""
    pipeline_layout_shapes(cfg, pp)
    lpp = cfg.n_layers // pp
    stack = (torch.stack if torch.is_tensor(tree["embed"]) else np.stack)
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["stages"] = {
        k: stack([stack([tree["layers"][s * lpp + j][k] for j in range(lpp)])
                  for s in range(pp)])
        for k in _STAGE_KEYS
    }
    return out


def unstack_pipeline(tree: Dict, cfg) -> Dict:
    """The flat ``init_params`` layout of a pipelined tree."""
    stages = tree["stages"]
    pp, lpp = stages["wo"].shape[:2]
    out = {k: v for k, v in tree.items() if k != "stages"}
    out["layers"] = [{k: stages[k][s][j] for k in _STAGE_KEYS}
                     for s in range(pp) for j in range(lpp)]
    return out


def _load_exact(tree: Dict, shapes: Dict, device, dtype) -> Dict:
    """Each float leaf of ``tree`` as a tensor in ``dtype`` on ``device``,
    after its keys and shapes are checked against ``shapes``."""
    _check_keys(tree, shapes)
    return _tree_map(lambda path, x: _float_leaf(
        "/".join(map(str, path)), x, tuple(_lookup(shapes, path)), device,
        dtype), tree)


def pipeline_params_from_jax(tree: Dict, cfg, pp: int, device="cuda",
                             dtype=None) -> Dict:
    """A JAX ``init_pipeline_params`` tree -> the port's pipelined params
    (the same keys and axis layout), in ``dtype`` (default f32: the
    pipeline steps store f32 leaves and compute in cfg.dtype) on
    ``device``."""
    return _load_exact(tree, pipeline_layout_shapes(cfg, pp), device,
                       dtype or torch.float32)


def stage_params_from_jax(tree: Dict, device="cuda", dtype=None) -> Dict:
    """A JAX ``init_stage_params`` tree (``{"w1": [pp, d, ff], "w2": [pp,
    ff, d]}``) -> torch tensors in ``dtype`` (default f32) on ``device``."""
    w1 = np.shape(tree["w1"])
    shapes = {"w1": w1, "w2": (w1[0], w1[2], w1[1])}
    return _load_exact(tree, shapes, device, dtype or torch.float32)
