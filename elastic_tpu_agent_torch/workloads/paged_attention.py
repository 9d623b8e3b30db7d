"""Paged-attention decode for the PyTorch port's serving engine.

Counterpart of ``elastic_tpu_agent/workloads/paged_attention.py``. The
Pallas TPU kernel ``_paged_kernel`` becomes a CUDA kernel written by hand
for Hopper (``csrc/paged_decode.cu``): one CTA per (slot, kv head) reads
its own block-table row and length (the TPU kernel had them scalar-
prefetched), streams only the blocks from the window's first to
ceil(len / bs), and skips masked positions. Its plain version is
``paged_decode_attention_reference``, the gather-based form; the wrapper
takes it only for tensors on the CPU, and for a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ..kernels import CudaKernel
from .attention import KERNEL_DTYPES, KERNEL_HEAD_DIMS, NEG_INF

MAX_GROUP = 16       # query heads per kv head the kernel holds
MAX_BLOCK_SIZE = 64  # pool block size the kernel holds

# C entry: csrc/paged_decode.cu `paged_decode`
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
PAGED_DECODE = CudaKernel(
    "paged_decode", "paged_decode",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _F, _I, _P],
)


def _check(q, pool_k, pool_v, table, lengths, kv_heads):
    if q.dim() != 3 or pool_k.dim() != 4 or table.dim() != 2:
        raise ValueError(
            f"q {tuple(q.shape)} / pool {tuple(pool_k.shape)} / table "
            f"{tuple(table.shape)}: want [slots,n,h] / [blocks,bs,g,h] / "
            "[slots,nb]"
        )
    slots, n, h = q.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v shapes differ")
    if pool_k.shape[2] != kv_heads or pool_k.shape[3] != h or n % kv_heads:
        raise ValueError(
            f"pool {tuple(pool_k.shape)} vs {n} heads / {kv_heads} kv "
            f"heads / head_dim {h}"
        )
    if table.shape[0] != slots or tuple(lengths.shape) != (slots,):
        raise ValueError("table/lengths rows must match q's slots")


def _paged_decode_cuda(q, pool_k, pool_v, table, lengths, kv_heads, window):
    slots, n, h = q.shape
    nb, bs = table.shape[1], pool_k.shape[1]
    for name, x in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("table", table), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in KERNEL_DTYPES or pool_k.dtype != q.dtype or (
        pool_v.dtype != q.dtype
    ):
        raise ValueError(
            f"paged kernel takes one float32/bfloat16 dtype for q and the "
            f"pool, not {q.dtype}/{pool_k.dtype}/{pool_v.dtype}"
        )
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("table and lengths must be int32")
    if h not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim 64/128, not {h}")
    if n // kv_heads > MAX_GROUP or bs > MAX_BLOCK_SIZE:
        raise ValueError(
            f"paged kernel holds <= {MAX_GROUP} query heads per kv head and "
            f"blocks of <= {MAX_BLOCK_SIZE} (got {n // kv_heads}, {bs})"
        )
    if q.stride(2) != 1 or pool_k.stride(3) != 1 or (
        pool_v.stride() != pool_k.stride()
    ):
        raise ValueError(
            "paged kernel needs contiguous head_dim and equal pool strides"
        )
    if table.stride(1) != 1 or not lengths.is_contiguous():
        raise ValueError("table rows and lengths must be contiguous")
    out = torch.empty((slots, n, h), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        PAGED_DECODE(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            KERNEL_DTYPES[q.dtype], slots, n, kv_heads, h, nb, bs,
            q.stride(0), q.stride(1),
            pool_k.stride(0), pool_k.stride(1), pool_k.stride(2),
            table.stride(0), 1.0 / math.sqrt(h), int(window), stream,
        )
    return out


def paged_decode_attention(
    q, pool_k, pool_v, table, lengths, kv_heads: int, window: int = 0,
):
    """One decode token per slot against the paged KV pool.

    q [slots, n, h]; pool_k/pool_v [n_blocks, bs, g, h] (ONE layer's
    pool); table [slots, nb] int32 physical block ids (junk 0 where
    unmapped); lengths [slots] int32 = number of VALID positions (the
    row's cached length INCLUDING the just-written decode token).
    Returns [slots, n, h]. Query head i reads kv head i // (n / g).
    A row of length 0 attends nothing: the kernel writes 0 there."""
    _check(q, pool_k, pool_v, table, lengths, kv_heads)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pool_k, pool_v, table, lengths, kv_heads, window=window
        )
    return _paged_decode_cuda(
        q, pool_k, pool_v, table, lengths, kv_heads, window
    )


def paged_decode_attention_reference(
    q, pool_k, pool_v, table, lengths, kv_heads: int, window: int = 0
):
    """Gather-based plain version: materialise each slot's dense view and
    run masked softmax attention in f32, the computation the kernel must
    reproduce."""
    slots, n, h = q.shape
    g = kv_heads
    r = n // g
    nb = table.shape[1]
    bs = pool_k.shape[1]
    flat = table.reshape(-1).long()
    kg = pool_k[flat].reshape(slots, nb * bs, g, h)
    vg = pool_v[flat].reshape(slots, nb * bs, g, h)
    q5 = q.reshape(slots, g, r, h).float()
    scale = 1.0 / math.sqrt(h)
    scores = torch.einsum("sgrh,sSgh->sgrS", q5, kg.float()) * scale
    cols = torch.arange(nb * bs, device=q.device)
    lens = lengths.to(cols.dtype)
    keep = cols[None, :] < lens[:, None]                    # [slots, S]
    if window > 0:
        keep &= (lens[:, None] - 1 - cols[None, :]) < window
    scores = torch.where(keep[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("sgrS,sSgh->sgrh", probs, vg.float())
    return out.reshape(slots, n, h).to(q.dtype)


def kernel_traffic(
    slots: int, table_blocks: int, block_size: int, kv_heads: int,
    head_dim: int, itemsize: int, n_heads: Optional[int] = None,
    lengths: Optional[Sequence[int]] = None, window: int = 0,
) -> dict:
    """Device-memory traffic and arithmetic of one launch of the Hopper
    kernel, from its grid: (slots, g) CTAs; each reads its table row and
    length, the attended K and V rows of its kv head (each once, from
    the window's first block to ceil(len / bs), never past the table),
    its r query rows, and writes r output rows. ``lengths`` None counts
    every table entry as full (the most one launch can read)."""
    g, h, bs, nb = kv_heads, head_dim, block_size, table_blocks
    n = n_heads or g
    if lengths is None:
        lengths = [nb * bs] * slots
    positions = blocks = 0
    for ln in lengths:
        ln = min(int(ln), nb * bs)
        first = max(0, ln - window) if window > 0 else 0
        positions += ln - first
        if ln > first:
            blocks += -(-ln // bs) - first // bs
    kv_read = positions * g * h * itemsize * 2
    qo = slots * n * h * itemsize * 2
    index = slots * (nb + 1) * 4
    return {
        "grid": (slots, g),
        "blocks_streamed": blocks * g,
        "reads_per_block": 1,
        "positions_attended": positions,
        "kv_bytes_read": kv_read,
        "bytes": kv_read + qo + index,
        "flops": 4 * positions * (n // g) * g * h,
    }
