"""Flagship decoder-only transformer LM, PyTorch port: forward, train step
and eval.

Counterpart of ``elastic_tpu_agent/workloads/transformer.py``: the same
config fields, the same parameter tree (``weights.params_from_jax`` loads a
JAX ``init_params`` tree, axis layout kept), the same layer body. Plain
functions on a dict of tensors, as the JAX code is functions on a pytree.
The attention core is the Hopper flash kernel (forward and backward)
wherever its gate admits the shape (head_dim 64 or 128); the projections
and MLP stay ``torch.einsum``, as the JAX package leaves them to XLA.

``make_train_step`` is the JAX train step on one device: the shifted
cross entropy, autograd for ``jax.value_and_grad``, optax's ``adamw`` as
``AdamW``, gradient accumulation, the parameter EMA and f32 master
weights. ``make_eval_fn`` is the eval loss.

One device: every ``moe_every``-th layer of a model with ``moe_experts``
> 0 is a Switch MoE layer (``moe.py``), whose aux loss the forward sums.
Ring attention and zero1 come with the multi-GPU slice and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention import (
    auto_flash_config,
    flash_attention,
    reference_attention,
    supports_flash,
)
from .moe import moe_mlp
from .quantize import embed_lookup, is_quantized, wdense
from .weights import _tree_map, jax_layout_shapes


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: Any = torch.bfloat16
    # Grouped-query attention: number of shared k/v heads (0 = MHA).
    n_kv_heads: int = 0
    # Position encoding: "learned" (table added to embeddings) or "rope".
    pos: str = "learned"
    rope_theta: float = 10000.0
    # Sliding-window attention: each token attends only the last
    # ``window`` positions (0 = full causal).
    window: int = 0
    # Attention core: "auto" picks the flash kernel when its gate admits
    # the shape, the materialised-scores einsum otherwise; "flash" and
    # "reference" force one ("ring" comes with the multi-GPU slice).
    attn: str = "auto"
    # Recompute each layer in the backward (torch.utils.checkpoint, as
    # jax.checkpoint): more FLOPs for fewer saved activations. Only acts
    # where autograd records the forward.
    remat: bool = False
    # Mixture-of-Experts: with moe_experts > 0, every ``moe_every``-th
    # layer replaces its dense MLP with a Switch MoE layer (moe.py).
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if self.attn == "ring":
            raise NotImplementedError(
                "ring attention comes with the multi-GPU slice of the port"
            )
        if self.attn not in ("auto", "flash", "reference"):
            raise ValueError(f"unknown attn {self.attn!r}")
        if self.pos not in ("learned", "rope"):
            raise ValueError(f"unknown pos {self.pos!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def is_gqa(self) -> bool:
        return self.kv_heads != self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and i % self.moe_every == (
            self.moe_every - 1
        )


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda", dtype=None,
) -> Dict:
    """Random params in the JAX ``init_params`` layout (normal(0.02)
    weights, unit norm scales), drawn from ``generator`` on the CPU and
    stored in ``dtype`` (default cfg.dtype) on ``device``. For convenience
    only: parity with the JAX package always goes through
    ``weights.params_from_jax``."""

    def draw(shape):
        return torch.randn(shape, generator=generator) * 0.02

    tree = _tree_map(
        lambda path, shape: (
            torch.ones(shape) if path[-1].endswith("_scale") else draw(shape)
        ),
        jax_layout_shapes(cfg),
    )
    return _tree_map(
        lambda path, t: t.to(device=device, dtype=dtype or cfg.dtype), tree
    )


# -- model ---------------------------------------------------------------


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """Rotary position embedding. x: [b, s, n, h] (h even); positions:
    [s] shared across the batch, or [b, s] per row. Interleaved pairs
    (x[2i], x[2i+1]) rotate by pos * theta^(-2i/h), in f32."""
    h = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, h, 2, dtype=torch.float32, device=x.device) / h
    )
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).reshape(x.shape)
    return out.to(x.dtype)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
) -> torch.Tensor:
    """Dispatch the attention core: q [b,s,n,h], k/v [b,s,g,h] ->
    [b,s,n,h]. The flash kernel reads grouped kv heads in place; the
    reference path repeats them, as the JAX layer body does."""
    s, h = q.shape[1], q.shape[3]
    impl = cfg.attn
    if impl == "auto":
        impl = (
            "flash" if supports_flash(s, h)
            else "reference"
        )
    if impl == "flash":
        fc = dataclasses.replace(auto_flash_config(s), window=cfg.window)
        return flash_attention(q, k, v, fc)
    return reference_attention(q, k, v, causal=True, window=cfg.window)


def _attention(x: torch.Tensor, layer: Dict, cfg: ModelConfig) -> torch.Tensor:
    if "wq" in layer:  # GQA: separate q and shared-kv projections
        q = torch.einsum("bsd,dnh->bsnh", x, wdense(layer, "wq", cfg.dtype))
        kv = torch.einsum(
            "bsd,dcgh->bcsgh", x, wdense(layer, "wkv", cfg.dtype)
        )
        k, v = kv[:, 0], kv[:, 1]
    else:
        qkv = torch.einsum(
            "bsd,dcnh->bcsnh", x, wdense(layer, "wqkv", cfg.dtype)
        )
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [b, s, n, h]
    if cfg.pos == "rope":
        positions = torch.arange(x.shape[1], device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)  # at kv width, cheaper
    out = _attention_core(q, k, v, cfg)
    return torch.einsum("bsnh,nhd->bsd", out, wdense(layer, "wo", cfg.dtype))


def _mlp(x: torch.Tensor, layer: Dict, cfg: ModelConfig) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, wdense(layer, "w1", cfg.dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.einsum("bsf,fd->bsd", h, wdense(layer, "w2", cfg.dtype))


def _check_device(params: Dict, device: torch.device) -> None:
    embed = params["embed"]
    where = (embed["q"] if is_quantized(embed) else embed).device
    if where != device:
        raise ValueError(
            f"params live on {where}, the call asked for {device}; load "
            "them with weights.params_from_jax(..., device=...)"
        )


def as_device(device) -> torch.device:
    """torch.device for ``device``; a bare "cuda" means the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def forward_with_aux(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token logits [b, s, vocab] in cfg.dtype, the MoE layers' summed
    aux loss: 0.0 for dense models). Runs on ``device``, where ``params``
    must already live. Differentiable: autograd records a graph only when
    a parameter requires grad, so bridged serving params run without
    one."""
    device = as_device(device)
    _check_device(params, device)
    tokens = torch.as_tensor(tokens, device=device).long()
    _, s = tokens.shape
    x = embed_lookup(params, tokens, cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(cfg.dtype)[:s][None]

    zero = torch.zeros((), dtype=torch.float32, device=device)

    def layer_fn(x, layer):
        x = x + _attention(_rmsnorm(x, layer["ln1_scale"]), layer, cfg)
        h = _rmsnorm(x, layer["ln2_scale"])
        if "moe" in layer:
            y, aux = moe_mlp(h, layer["moe"], cfg.moe_capacity_factor)
        else:
            y, aux = _mlp(h, layer, cfg), zero
        return x + y, aux

    aux_total = zero
    for layer in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x, aux = layer_fn(x, layer)
        aux_total = aux_total + aux
    x = _rmsnorm(x, params["final_norm_scale"])
    logits = torch.einsum(
        "bsd,dv->bsv", x, wdense(params, "lm_head", cfg.dtype)
    )
    return logits, aux_total


def forward(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> torch.Tensor:
    """Token logits (aux loss discarded; see forward_with_aux)."""
    return forward_with_aux(params, tokens, cfg, device)[0]


# -- training step ---------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda path, t: out.append(t), tree)
    return out


def _like(tree, leaves) -> Dict:
    """A tree shaped like ``tree`` holding ``leaves`` in _leaves order."""
    it = iter(leaves)
    return _tree_map(lambda path, _: next(it), tree)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy on f32 logits (optax's
    softmax_cross_entropy_with_integer_labels, then the mean)."""
    return F.cross_entropy(
        logits.float().flatten(0, 1), targets.flatten(), reduction="mean"
    )


def loss_and_grads(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the train step's loss on tokens [b, seq+1]: the
    mean cross entropy of the shifted targets plus moe_aux_coef * aux, and
    its gradient as a tree shaped like ``params`` in each leaf's dtype
    (``jax.value_and_grad(loss_fn)`` in the JAX ``make_train_step``). The
    caller's tensors are left as they are: the gradient is taken through
    aliases that require grad."""
    device = as_device(device)
    tokens = torch.as_tensor(tokens, device=device).long()
    live = _tree_map(lambda path, p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits, aux = forward_with_aux(live, tokens[:, :-1], cfg, device)
        loss = _nll(logits, tokens[:, 1:]) + cfg.moe_aux_coef * aux
        grads = torch.autograd.grad(loss, _leaves(live))
    return loss.detach(), _like(params, grads)


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamW:
    """``optax.adamw(learning_rate)`` as the JAX train step builds it
    (b1 0.9, b2 0.999, eps 1e-8 added outside the square root, weight
    decay 1e-4 on every leaf, bias correction from the step count,
    ``learning_rate`` a float or a schedule ``count -> lr``), chained, for
    ``ema_decay`` > 0, with the parameter EMA of the JAX ``EmaState``
    stage, and holding the f32 masters under ``master_weights``.

    The state is a plain dict of tensors, as optax's is a tree: ``count``
    (int32, kept on the host so the bias correction and a schedule read
    it without waiting on the device), ``mu`` and ``nu`` (trees like the
    params), then ``ema`` (the EmaState's tree) and ``masters`` (f32)
    where enabled. ``update_`` applies one step in place."""

    # optax.adamw's defaults; weight decay is 1e-4 there, not torch's 1e-2
    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 1e-4

    def __init__(
        self, learning_rate: Union[float, Callable[[int], float]] = 1e-3,
        ema_decay: float = 0.0, master_weights: bool = False,
    ):
        if not 0.0 <= ema_decay < 1.0:
            # decay 1.0 would freeze the EMA at its init forever
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        self.learning_rate = learning_rate
        self.ema_decay = ema_decay
        self.master_weights = master_weights

    def init(self, params: Dict) -> Dict:
        """Optimizer state for ``params`` as stored (``cfg.dtype`` live
        leaves under master_weights, whose f32 masters it copies)."""
        base = params
        if self.master_weights:
            base = _tree_map(lambda path, p: p.detach().float(), params)
        state = {
            "count": torch.zeros((), dtype=torch.int32),
            "mu": _tree_map(lambda path, p: torch.zeros_like(p), base),
            "nu": _tree_map(lambda path, p: torch.zeros_like(p), base),
        }
        if self.ema_decay > 0.0:
            state["ema"] = _tree_map(lambda path, p: p.detach().clone(), base)
        if self.master_weights:
            state["masters"] = base
        return state

    @torch.no_grad()
    def update_(self, grads: Dict, state: Dict, params: Dict) -> None:
        """One AdamW step from ``grads``, in place on ``state`` and
        ``params`` (the JAX step donates both). Under master_weights the
        f32 masters take the update and the live leaves are re-rounded
        from them."""
        count = int(state["count"])
        lr = (
            self.learning_rate(count) if callable(self.learning_rate)
            else self.learning_rate
        )
        # f32 bias corrections from the incremented count, as optax
        bc1 = _f32(1.0 - np.float32(self.b1) ** np.float32(count + 1))
        bc2 = _f32(1.0 - np.float32(self.b2) ** np.float32(count + 1))
        targets = _leaves(state["masters"] if self.master_weights else params)
        gs = _leaves(grads)
        if self.master_weights:
            gs = [g.float() for g in gs]
        mus, nus = _leaves(state["mu"]), _leaves(state["nu"])
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, targets, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(targets, upd)
        if self.ema_decay > 0.0:
            ema = _leaves(state["ema"])
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, targets, alpha=1.0 - self.ema_decay)
        if self.master_weights:
            torch._foreach_copy_(_leaves(params), targets)
        state["count"] += 1


def ema_params(opt_state: Dict) -> Optional[Dict]:
    """The EMA tree of an optimizer state built with ema_decay > 0 (None
    without): the JAX package's ``EmaState.ema``."""
    return opt_state.get("ema")


def make_train_step(
    cfg: ModelConfig,
    learning_rate: Union[float, Callable[[int], float]] = 1e-3,
    accum_steps: int = 1, ema_decay: float = 0.0,
    master_weights: bool = False, zero1: bool = False, device="cuda",
):
    """(train_step, init_all, optimizer) for one device, as the JAX
    ``make_train_step`` returns them.

    ``train_step(params, opt_state, tokens) -> (params, opt_state, loss)``
    takes tokens [batch, seq+1] (targets are the shift by one), or
    [accum_steps, batch, seq+1] when ``accum_steps`` > 1: then the f32
    gradients of the micro-batches are summed, their mean is cast back to
    each param's dtype (not under master_weights, whose f32 optimizer
    takes the f32 mean) and one optimizer update applies it; the loss is
    the micro-batches' mean. MoE layers route and cap each micro-batch on
    its own, so aux losses and capacity drops are micro-batch local, as in
    the JAX step. The step UPDATES ``params`` and ``opt_state``
    IN PLACE (the JAX step donates both) and returns the same objects;
    the loss is a 0-dim f32 tensor on the device.

    ``init_all(generator)`` draws params like ``init_params`` and stores
    them as the JAX step does: f32, or cfg.dtype live leaves under
    ``master_weights``. ``optimizer`` is the ``AdamW``; its ``init(params)``
    starts the state for params loaded another way (the weight bridge with
    ``dtype=torch.float32``). ``learning_rate``, ``ema_decay`` and
    ``master_weights`` are those of the JAX step. ``zero1`` shards the
    optimizer state over data-parallel ranks and raises here."""
    if zero1:
        raise NotImplementedError(
            "zero1 shards the optimizer state over data-parallel ranks: it "
            "comes with the multi-GPU slice of the port"
        )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = as_device(device)
    optimizer = AdamW(
        learning_rate, ema_decay=ema_decay, master_weights=master_weights
    )

    def grads_of(params, tokens):
        if accum_steps == 1:
            return loss_and_grads(params, tokens, cfg, device)
        if tokens.dim() != 3 or tokens.shape[0] != accum_steps:
            raise ValueError(
                f"tokens {tuple(tokens.shape)}: want [{accum_steps}, batch, "
                "seq+1] with accum_steps > 1"
            )
        gsum, lsum = None, None
        for micro in tokens:
            loss, grads = loss_and_grads(params, micro, cfg, device)
            g32 = [g.float() for g in _leaves(grads)]
            if gsum is None:
                gsum, lsum = g32, loss
            else:
                torch._foreach_add_(gsum, g32)
                lsum = lsum + loss
        torch._foreach_div_(gsum, accum_steps)
        if not master_weights:
            gsum = [g.to(p.dtype) for g, p in zip(gsum, _leaves(params))]
        return lsum / accum_steps, _like(params, gsum)

    def train_step(params, opt_state, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        loss, grads = grads_of(params, tokens)
        optimizer.update_(grads, opt_state, params)
        return params, opt_state, loss

    def init_all(generator: torch.Generator):
        stored = cfg.dtype if master_weights else torch.float32
        params = init_params(cfg, generator, device, dtype=stored)
        return params, optimizer.init(params)

    return train_step, init_all, optimizer


def make_eval_fn(cfg: ModelConfig, device="cuda"):
    """(params, tokens [b, seq+1]) -> mean next-token NLL (f32 0-dim
    tensor), with no MoE aux term and no graph."""
    device = as_device(device)

    @torch.no_grad()
    def eval_loss(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        logits, _ = forward_with_aux(params, tokens[:, :-1], cfg, device)
        return _nll(logits, tokens[:, 1:])

    return eval_loss
