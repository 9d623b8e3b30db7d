"""Attention for the PyTorch port: the flash-attention forward.

Counterpart of ``elastic_tpu_agent/workloads/attention.py``. The Pallas
TPU kernel ``_fwd_kernel`` becomes a CUDA kernel written by hand for
Hopper (``csrc/flash_fwd.cu``); ``flash_attention_plain`` beside it
computes the same ``(o, lse)`` with materialised scores. The wrapper takes
the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.

Forward only: the backward kernels (``_dkdv_kernel``, ``_dq_kernel``)
belong to the training slice, so asking for a gradient raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..kernels import CudaKernel

NEG_INF = -1e30  # large-negative instead of -inf: keeps exp/where NaN-free

# The CUDA kernel's q/k tile and the head dims it is compiled for; it
# masks a ragged last tile itself, so any sequence length is admitted.
KERNEL_TILE = 64
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    """Static attention parameters. The tile is not one of them: the
    Hopper kernel is compiled for KERNEL_TILE x KERNEL_TILE only."""

    causal: bool = True
    sm_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    # Sliding window: each query attends only the last ``window``
    # positions (0 = unlimited). Requires causal.
    window: int = 0


def supports_flash(seq: int, head_dim: int) -> bool:
    """Shape gate of the Hopper kernel: head_dim 64 or 128. (The TPU gate
    demanded head_dim % 128 and tiles dividing seq; this kernel masks a
    ragged last tile.)"""
    return seq > 0 and head_dim in KERNEL_HEAD_DIMS


def auto_flash_config(seq: int) -> FlashConfig:
    """The kernel's one tile shape serves every sequence length."""
    return FlashConfig()


def _repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[b, s, g, h] -> [b, s, n, h]: query head i reads kv head i // r
    (jnp.repeat's contiguous groups)."""
    g = x.shape[2]
    if g == n_heads:
        return x
    if n_heads % g:
        raise ValueError(f"{n_heads} query heads over {g} kv heads")
    return torch.repeat_interleave(x, n_heads // g, dim=2)


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    sm_scale: Optional[float] = None, window: int = 0,
) -> torch.Tensor:
    """Plain materialised-scores attention. [b, s, n, h] -> [b, s, n, h].
    k/v may carry fewer (grouped) heads. ``window`` > 0 limits each query
    to the last ``window`` positions."""
    n = q.shape[2]
    k, v = _repeat_kv(k, n), _repeat_kv(v, n)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bsnh,btnh->bnst", q, k) * scale
    s, t = logits.shape[-2], logits.shape[-1]
    if causal:
        mask = _causal_mask(s, t, window, q.device)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v)


def _causal_mask(s: int, t: int, window: int, device) -> torch.Tensor:
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    mask = rows >= cols
    if window > 0:
        mask &= rows - cols < window
    return mask


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernel's function with materialised scores: (o [b,s,n,h],
    lse [b,n,s] f32). Same arithmetic as the kernel: f32 scores from the
    inputs' values, NEG_INF masking, unnormalised p rounded to v's dtype
    before P.V, l clamped at 1e-30, lse = m + log(l)."""
    b, s, n, h = q.shape
    k, v = _repeat_kv(k, n), _repeat_kv(v, n)
    scale = cfg.sm_scale if cfg.sm_scale is not None else 1.0 / math.sqrt(h)
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float()) * scale
    if cfg.causal:
        mask = _causal_mask(s, s, cfg.window, q.device)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bnst,btnh->bnsh", p.to(v.dtype).float(), v.float())
    o = (pv / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l))[..., 0]
    return o, lse


# C entry: csrc/flash_fwd.cu `flash_fwd`
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _I, _P],
)


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper flash-forward kernel on [b, s, n, h] tensors
    (k/v may have g | n heads), read through their strides."""
    b, s, n, h = q.shape
    g = k.shape[2]
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4 or (x.shape[0], x.shape[1], x.shape[3]) != (b, s, h):
            raise ValueError(
                f"{name} shape {tuple(x.shape)} vs q {tuple(q.shape)}"
            )
    if v.shape[2] != g or n % g:
        raise ValueError(f"kv heads {g}/{v.shape[2]} do not divide {n}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32/bfloat16, not {q.dtype}")
    if h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim 64/128, not {h}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous head_dim axis")
    o = torch.empty((b, s, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device)
    scale = cfg.sm_scale if cfg.sm_scale is not None else 1.0 / math.sqrt(h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_FWD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, s, n, g, h,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            scale, int(cfg.causal), int(cfg.window), stream,
        )
    return o, lse


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cfg: FlashConfig = FlashConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward returning (o [b,s,n,h], lse [b,n,s]).
    Requires the shape gate (callers dispatch; no fallback here)."""
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash attention is forward-only in this port: its backward "
            "kernels (_dkdv_kernel, _dq_kernel) come with the training "
            "slice; call under torch.no_grad()"
        )
    if not supports_flash(q.shape[1], q.shape[3]):
        raise ValueError(
            f"shape {tuple(q.shape)} / {cfg} is outside the flash gate"
        )
    if cfg.window > 0 and not cfg.causal:
        raise ValueError("sliding-window attention requires causal")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cfg)
    return _flash_fwd_cuda(q, k, v, cfg)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cfg: FlashConfig = FlashConfig(),
) -> torch.Tensor:
    """Flash attention. [b, s, n, h] -> [b, s, n, h] (k/v may carry g | n
    heads). Falls back to `reference_attention` when the shape gate
    fails, so callers never need their own dispatch."""
    if cfg.window > 0 and not cfg.causal:
        raise ValueError("sliding-window attention requires causal")
    if not supports_flash(q.shape[1], q.shape[3]):
        return reference_attention(
            q, k, v, causal=cfg.causal, sm_scale=cfg.sm_scale,
            window=cfg.window,
        )
    return flash_attention_with_lse(q, k, v, cfg)[0]
