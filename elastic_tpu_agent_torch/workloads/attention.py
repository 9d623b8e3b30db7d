"""Attention for the PyTorch port: flash attention, forward and backward.

Counterpart of ``elastic_tpu_agent/workloads/attention.py``. The Pallas
TPU kernels become CUDA kernels written by hand for Hopper: ``_fwd_kernel``
is ``csrc/flash_fwd.cu`` (wgmma and TMA for bfloat16, FP32 FMAs for
float32); the backward's ``_dkdv_kernel`` and
``_dq_kernel`` are ``flash_bwd_dkdv`` and ``flash_bwd_dq`` in
``csrc/flash_bwd.cu`` (wgmma and TMA for bfloat16, FP32 FMAs for
float32; the Hopper helpers both sources share are ``csrc/sm90.cuh``).
Beside each kernel a plain version computes the
same function with materialised scores (``flash_attention_plain``,
``flash_bwd_dkdv_plain``, ``flash_bwd_dq_plain``). Every wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises.

``flash_attention`` and ``flash_attention_with_lse`` share one
``torch.autograd.Function``: the forward saves ``(q, k, v, o, lse)`` and
the backward recomputes the probabilities from ``lse``, as ``_flash_bwd``
does, folding the lse cotangent (if lse was used) into ``delta``.
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


# -- backward: plain versions --------------------------------------------


def _scale(cfg: FlashConfig, head_dim: int) -> float:
    return cfg.sm_scale if cfg.sm_scale is not None else 1.0 / math.sqrt(
        head_dim
    )


def flash_bwd_delta(
    o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32 from the stored dtypes, minus the lse
    cotangent when one is given: [b, n, s] f32, contiguous. Elementwise
    work that the JAX package leaves to XLA, so a torch expression here
    too. Folding -dlse into delta routes d lse / d s = p through the
    kernels unchanged (``_flash_bwd``)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _recompute_p(q, k, lse, cfg: FlashConfig) -> torch.Tensor:
    """p = exp(s - lse) [b, n, s, t] f32: f32 scores from the inputs'
    values, masked at NEG_INF (so masked p is exactly 0)."""
    n, s = q.shape[2], q.shape[1]
    scores = torch.einsum(
        "bsnh,btnh->bnst", q.float(), _repeat_kv(k, n).float()
    ) * _scale(cfg, q.shape[-1])
    if cfg.causal:
        mask = _causal_mask(s, s, cfg.window, q.device)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    return torch.exp(scores - lse[..., None])


def _ds(q, k, v, do, lse, delta, cfg: FlashConfig):
    """(p, ds = p * (dO.V^T - delta) * scale), both [b, n, s, t] f32."""
    p = _recompute_p(q, k, lse, cfg)
    dp = torch.einsum(
        "bsnh,btnh->bnst", do.float(), _repeat_kv(v, q.shape[2]).float()
    )
    return p, p * (dp - delta[..., None]) * _scale(cfg, q.shape[-1])


def _group_sum(x: torch.Tensor, g: int) -> torch.Tensor:
    """[b, s, n, h] -> [b, s, g, h]: the sum over each kv head's n/g query
    heads (the gradient of the JAX layer's contiguous-group repeat)."""
    b, s, n, h = x.shape
    return x.reshape(b, s, g, n // g, h).sum(3)


def flash_bwd_dkdv_plain(
    q, k, v, do, lse, delta, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function: (dk, dv) [b, s, g, h] in k's / v's
    dtype. Rounds where ``_dkdv_kernel`` rounds: p to dO's dtype before
    p^T.dO, ds to q's dtype before ds^T.q; sums in f32 over q rows and over
    the group's query heads, then casts once."""
    p, ds = _ds(q, k, v, do, lse, delta, cfg)
    dv = torch.einsum("bnst,bsnh->btnh", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnst,bsnh->btnh", ds.to(q.dtype).float(), q.float())
    g = k.shape[2]
    return _group_sum(dk, g).to(k.dtype), _group_sum(dv, g).to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, cfg: FlashConfig):
    """The dQ kernel's function: dq [b, s, n, h] in q's dtype, with ds
    rounded to k's dtype before ds.k, as ``_dq_kernel`` does."""
    _, ds = _ds(q, k, v, do, lse, delta, cfg)
    dq = torch.einsum(
        "bnst,btnh->bsnh", ds.to(k.dtype).float(),
        _repeat_kv(k, q.shape[2]).float(),
    )
    return dq.to(q.dtype)


def flash_attention_bwd_plain(
    q, k, v, o, lse, do, cfg: FlashConfig, dlse=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention from the forward's saved (q, k, v,
    o, lse) and the cotangents (do, dlse), as ``_flash_bwd`` computes
    them; k/v may carry g | n heads and get [b, s, g, h] gradients."""
    delta = flash_bwd_delta(o, do, dlse)
    dk, dv = flash_bwd_dkdv_plain(q, k, v, do, lse, delta, cfg)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta, cfg), dk, dv


# C entry: csrc/flash_fwd.cu `flash_fwd`
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _I, _P],
)


def _check_kernel_inputs(q, k, v, *others) -> None:
    """Raise unless q [b,s,n,h], k/v [b,s,g,h] (g | n) and the [b,s,n,h]
    ``others`` share q's device and dtype (float32 or bfloat16), head_dim
    is 64 or 128 and every head_dim axis is contiguous."""
    b, s, n, h = q.shape
    g = k.shape[2]
    named = [("k", k, g), ("v", v, g)] + [
        (f"input {i + 4}", x, n) for i, x in enumerate(others)
    ]
    for name, x, heads in named:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4 or tuple(x.shape) != (b, s, heads, h):
            raise ValueError(
                f"{name} shape {tuple(x.shape)} vs q {tuple(q.shape)}"
            )
    if n % g:
        raise ValueError(f"{g} kv heads do not divide {n} query heads")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes float32/bfloat16, not {q.dtype}")
    if h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim 64/128, not {h}")
    if any(x.stride(-1) != 1 for x in (q, k, v, *others)):
        raise ValueError("flash kernel needs a contiguous head_dim axis")


def _check_rows(q, *rows) -> None:
    """lse/delta: contiguous f32 [b, n, s] on q's device."""
    b, s, n, _ = q.shape
    for x in rows:
        if (x.device != q.device or x.dtype != torch.float32
                or tuple(x.shape) != (b, n, s) or not x.is_contiguous()):
            raise ValueError(
                f"lse/delta must be contiguous float32 {(b, n, s)} on "
                f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )


def _tma_aligned(x: torch.Tensor) -> bool:
    """Whether TMA can read the [b, s, heads, h] tensor x in place: a
    16-byte aligned base and 16-byte multiples for the b, s and head
    strides (the head_dim axis is contiguous)."""
    size = x.element_size()
    return not (x.data_ptr() | x.stride(0) * size | x.stride(1) * size
                | x.stride(2) * size) % 16


def _check_tma(*xs) -> None:
    """The bf16 kernels (wgmma/TMA) read their [b, s, heads, h] inputs by
    TMA: raise unless every one is ``_tma_aligned``. The float32 kernels
    read through plain loads and take any strides."""
    if xs[0].dtype == torch.bfloat16 and not all(map(_tma_aligned, xs)):
        raise ValueError(
            "the bf16 flash kernels read q/k/v/dO by TMA: 16-byte aligned "
            "bases and strides"
        )


def _strides(*xs):
    return [st for x in xs for st in (x.stride(0), x.stride(1), x.stride(2))]


def _flash_fwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper flash-forward kernel on [b, s, n, h] tensors
    (k/v may have g | n heads), read through their strides: the wgmma/TMA
    instance for bfloat16, the FP32-FMA instance for float32."""
    _check_kernel_inputs(q, k, v)
    _check_tma(q, k, v)
    b, s, n, h = q.shape
    g = k.shape[2]
    o = torch.empty((b, s, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device)
    scale = cfg.sm_scale if cfg.sm_scale is not None else 1.0 / math.sqrt(h)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_FWD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), KERNEL_DTYPES[q.dtype], b, s, n, g, h,
            *_strides(q, k, v),
            scale, int(cfg.causal), int(cfg.window), stream,
        )
    return o, lse


# C entries: csrc/flash_bwd.cu `flash_bwd_dkdv`, `flash_bwd_dq`
_BWD_ARGS = [_I, _I, _I, _I, _I, _I] + [_L] * 12 + [_F, _I, _I, _P]
FLASH_BWD_DKDV = CudaKernel(
    "flash_bwd", "flash_bwd_dkdv", [_P] * 8 + _BWD_ARGS
)
FLASH_BWD_DQ = CudaKernel("flash_bwd", "flash_bwd_dq", [_P] * 7 + _BWD_ARGS)


def _launch_bwd(kernel, outs, q, k, v, do, lse, delta, cfg) -> None:
    """Launch one backward kernel on CUDA tensors, read through their
    strides: the wgmma/TMA instance for bfloat16, the FP32-FMA instance for
    float32."""
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    _check_tma(q, k, v, do)
    b, s, n, h = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
            KERNEL_DTYPES[q.dtype], b, s, n, k.shape[2], h,
            *_strides(q, k, v, do), _scale(cfg, h), int(cfg.causal),
            int(cfg.window), stream,
        )


def flash_bwd_dkdv(
    q, k, v, do, lse, delta, cfg: FlashConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [b, s, g, h]: the Hopper dK/dV kernel for CUDA tensors
    (read through their strides), its plain version for CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, cfg)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(FLASH_BWD_DKDV, (dk, dv), q, k, v, do, lse, delta, cfg)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, cfg: FlashConfig) -> torch.Tensor:
    """dq [b, s, n, h]: the Hopper dQ kernel for CUDA tensors, its plain
    version for CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, cfg)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(FLASH_BWD_DQ, (dq,), q, k, v, do, lse, delta, cfg)
    return dq


def _flash_fwd(q, k, v, cfg: FlashConfig):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, cfg)
    return _flash_fwd_cuda(q, k, v, cfg)


class _FlashAttentionWithLse(torch.autograd.Function):
    """(o, lse) = flash(q, k, v); backward through the dK/dV and dQ
    kernels, with the lse cotangent folded into delta. A cotangent of an
    output that was not used arrives as None."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        o, lse = _flash_fwd(q, k, v, cfg)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:          # only lse was used downstream
            do = torch.zeros_like(o)
        elif do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                                    and not _tma_aligned(do)):
            # a copy the kernels can read (the bf16 ones by TMA)
            do = do.clone(memory_format=torch.contiguous_format)
        delta = flash_bwd_delta(o, do, dlse)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.cfg)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.cfg)
        return dq, dk, dv, None


def _check_call(q, cfg: FlashConfig) -> None:
    if not supports_flash(q.shape[1], q.shape[3]):
        raise ValueError(
            f"shape {tuple(q.shape)} / {cfg} is outside the flash gate"
        )
    if cfg.window > 0 and not cfg.causal:
        raise ValueError("sliding-window attention requires causal")


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cfg: FlashConfig = FlashConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning (o [b,s,n,h], lse [b,n,s]), both
    differentiable. Requires the shape gate (callers dispatch; no
    fallback here)."""
    _check_call(q, cfg)
    return _FlashAttentionWithLse.apply(q, k, v, cfg)


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
    _check_call(q, cfg)
    return _FlashAttentionWithLse.apply(q, k, v, cfg)[0]
