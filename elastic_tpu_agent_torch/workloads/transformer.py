"""Flagship decoder-only transformer LM, PyTorch port (forward only).

Counterpart of ``elastic_tpu_agent/workloads/transformer.py``: the same
config fields, the same parameter tree (``weights.params_from_jax`` loads a
JAX ``init_params`` tree, axis layout kept), the same layer body. Plain
functions on a dict of tensors, as the JAX code is functions on a pytree.
The attention core is the Hopper flash kernel wherever its gate admits the
shape (head_dim 64 or 128); the projections and MLP stay ``torch.einsum``,
as the JAX package leaves them to XLA.

Dense models on one device only: MoE layers and ring attention come with
later slices and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .attention import (
    auto_flash_config,
    flash_attention,
    reference_attention,
    supports_flash,
)
from .quantize import embed_lookup, wdense


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
    remat: bool = False  # training only; no effect on the forward
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if self.moe_experts > 0:
            raise NotImplementedError(
                "MoE layers come with a later slice of the port (dense only)"
            )
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
    cfg: ModelConfig, generator: torch.Generator, device="cuda"
) -> Dict:
    """Random params in the JAX ``init_params`` layout (normal(0.02)
    weights, unit norm scales), drawn from ``generator`` on the CPU and
    stored in cfg.dtype on ``device``. For convenience only: parity with
    the JAX package always goes through ``weights.params_from_jax``."""
    from .weights import _tree_map, jax_layout_shapes

    def draw(shape):
        return torch.randn(shape, generator=generator) * 0.02

    tree = _tree_map(
        lambda path, shape: (
            torch.ones(shape) if path[-1].endswith("_scale") else draw(shape)
        ),
        jax_layout_shapes(cfg),
    )
    return _tree_map(
        lambda path, t: t.to(device=device, dtype=cfg.dtype), tree
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
    where = params["embed"].device
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


@torch.no_grad()
def forward_with_aux(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token logits [b, s, vocab] in cfg.dtype, aux loss = 0.0: dense
    models have no MoE aux term). Runs on ``device``, where ``params``
    must already live."""
    device = as_device(device)
    _check_device(params, device)
    tokens = torch.as_tensor(tokens, device=device).long()
    _, s = tokens.shape
    x = embed_lookup(params, tokens, cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(cfg.dtype)[:s][None]
    for layer in params["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1_scale"]), layer, cfg)
        x = x + _mlp(_rmsnorm(x, layer["ln2_scale"]), layer, cfg)
    x = _rmsnorm(x, params["final_norm_scale"])
    logits = torch.einsum(
        "bsd,dv->bsv", x, wdense(params, "lm_head", cfg.dtype)
    )
    return logits, torch.zeros((), dtype=torch.float32, device=device)


def forward(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> torch.Tensor:
    """Token logits (aux loss discarded; see forward_with_aux)."""
    return forward_with_aux(params, tokens, cfg, device)[0]
