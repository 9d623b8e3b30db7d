"""LoRA, PyTorch port: low-rank adapters for parameter-efficient
fine-tuning.

Counterpart of ``elastic_tpu_agent/workloads/lora.py``. The base model is
frozen (no gradient, no optimizer state); each targeted weight, viewed 2-D
as [in, out] by a fixed split of its axes, gets f32 factors A [in, r] and
B [r, out]. The delta A @ B is computed at the weight's full shape inside
the step, cast to the base's dtype (a bf16 base rounds the delta before
the add, as JAX does) and added to the frozen weight, so the model code
runs unmodified on the effective params; autograd then reaches only the
adapters. B starts at zero, so step 0 is exactly the base model.
``merge_lora`` folds the adapters into plain params for serving.

The train step is the JAX one on one device: the forward through the
flash kernels (forward and backward) wherever their gate admits the
shape, f32 cross entropy plus ``moe_aux_coef`` times the MoE aux loss, and
``optax.adamw(learning_rate)`` (``transformer.AdamW``) over the adapter
tree alone.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from .quantize import _tree_map
from .transformer import (
    AdamW,
    ModelConfig,
    _check_device,
    _leaves,
    _like,
    _nll,
    as_device,
    forward_with_aux,
)

# Targeted weight name -> number of LEADING axes forming the "in" side of
# its matmul; the rest are "out" (each einsum's contraction).
_IN_AXES = {
    "wqkv": 1,   # [d, 3, n, h]
    "wq": 1,     # [d, n, h]
    "wkv": 1,    # [d, 2, g, h]
    "wo": 2,     # [n, h, d]
    "w1": 1,     # [d, f]
    "w2": 1,     # [f, d]
}

DEFAULT_TARGETS = ("wqkv", "wq", "wkv", "wo")


def _in_out(shape: Tuple[int, ...], n_in: int) -> Tuple[int, int]:
    return math.prod(shape[:n_in]), math.prod(shape[n_in:])


def init_lora_params(
    params: Dict,
    generator: torch.Generator,
    rank: int = 8,
    targets: Sequence[str] = DEFAULT_TARGETS,
    device="cuda",
) -> Dict:
    """Adapters mirroring the layer structure: layers[i][name] ->
    {"a": [in, r], "b": [r, out]}, f32 on ``device``: A ~ N(0, 1/r) drawn
    from ``generator`` on the CPU, B = 0.

    MoE expert weights (under layer["moe"]) are not adapted; MoE layers
    take attention adapters only. Target names must be known (``_IN_AXES``)
    but may match no layer: the defaults list both the fused-MHA and the
    GQA projection names."""
    unknown = set(targets) - set(_IN_AXES)
    if unknown:
        raise ValueError(
            f"unknown LoRA targets {sorted(unknown)}; "
            f"known: {sorted(_IN_AXES)}"
        )
    device = as_device(device)
    _check_device(params, device)
    adapters, matched = [], set()
    for layer in params["layers"]:
        entry = {}
        # _IN_AXES order, whatever the targets' order: the optimizer pairs
        # state and adapter leaves by tree order (JAX sorts dict keys)
        for name in _IN_AXES:
            if name not in targets or name not in layer:
                continue
            matched.add(name)
            d_in, d_out = _in_out(tuple(layer[name].shape), _IN_AXES[name])
            a = torch.randn((d_in, rank), generator=generator) / math.sqrt(
                rank)
            entry[name] = {
                "a": a.to(device),
                "b": torch.zeros((rank, d_out), device=device),
            }
        adapters.append(entry)
    if not matched:
        raise ValueError(
            f"no LoRA target in {sorted(targets)} matched any layer weight "
            f"(per-layer names: {sorted(params['layers'][0])})"
        )
    return {"layers": adapters}


def lora_param_count(lora: Dict) -> int:
    return sum(t.numel() for t in _leaves(lora))


def _apply_layer(base: Dict, adapters: Dict, scale: float) -> Dict:
    out = dict(base)
    for name, ab in adapters.items():
        w = base[name]
        delta = (ab["a"] @ ab["b"]).reshape(w.shape) * scale
        out[name] = w + delta.to(w.dtype)
    return out


def apply_lora(params: Dict, lora: Dict, scale: float = 1.0) -> Dict:
    """Effective params: base + scale * (A @ B) on every adapted weight.
    Differentiable with respect to ``lora`` (the train step's use); also
    the implementation of merge_lora."""
    return {
        **{k: v for k, v in params.items() if k != "layers"},
        "layers": [
            _apply_layer(layer, ad, scale)
            for layer, ad in zip(params["layers"], lora["layers"])
        ],
    }


@torch.no_grad()
def merge_lora(params: Dict, lora: Dict, scale: float = 1.0) -> Dict:
    """Fold adapters into a plain params tree for serving (generate,
    quantize_params and the serving engine take the result)."""
    return apply_lora(params, lora, scale)


def make_lora_train_step(
    cfg: ModelConfig,
    rank: int = 8,
    scale: float = 1.0,
    learning_rate: Union[float, Callable[[int], float]] = 1e-3,
    targets: Sequence[str] = DEFAULT_TARGETS,
    device="cuda",
):
    """(step, init), as the JAX function returns them.

    ``step(base, lora, opt_state, tokens) -> (lora, opt_state, loss)``
    with tokens [batch, seq+1]: gradients and optimizer state exist for
    the adapter tree only; the base is read, never differentiated or
    written. The step updates ``lora`` and ``opt_state`` in place (the
    JAX step returns new trees) and returns them; the loss is a 0-dim f32
    tensor on the device. ``init(params, generator=None) -> (lora,
    opt_state)`` draws the adapters (generator seeded 0 by default, as
    JAX's key(0))."""
    device = as_device(device)
    optimizer = AdamW(learning_rate)

    def step(base, lora, opt_state, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        live = _tree_map(lambda path, t: t.detach().requires_grad_(), lora)
        with torch.enable_grad():
            eff = apply_lora(base, live, scale)
            logits, aux = forward_with_aux(eff, tokens[:, :-1], cfg, device)
            loss = _nll(logits, tokens[:, 1:]) + cfg.moe_aux_coef * aux
            grads = torch.autograd.grad(loss, _leaves(live))
        optimizer.update_(_like(lora, grads), opt_state, lora)
        return lora, opt_state, loss.detach()

    def init(params: Dict, generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(0)
        lora = init_lora_params(
            params, generator, rank=rank, targets=targets, device=device
        )
        return lora, optimizer.init(lora)

    return step, init
