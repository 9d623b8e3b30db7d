"""Paged-attention decode for the PyTorch port's serving engine.

Counterpart of ``elastic_tpu_agent/workloads/paged_attention.py``. The
Pallas TPU kernel ``_paged_kernel`` becomes a CUDA kernel written by hand
for Hopper (``csrc/paged_decode.cu``), split over blocks: the grid is
(slots, kv heads, splits); each CTA reads its own length and its range of
the block-table row (the TPU kernel had them scalar-prefetched), streams
only the attended blocks of that range (from the window's first to
ceil(len / bs)), skips masked positions and writes a partial softmax
state; the last CTA of each (slot, kv head) merges them, in the same
launch. ``paged_splits`` picks the number of splits and
``paged_split_ranges`` is the kernel's cut, both in plain Python. The
plain version is ``paged_decode_attention_reference``, the
gather-based form; the wrapper takes it only for tensors on the CPU, and
for a CUDA tensor launches the kernel or raises.
``paged_decode_attention_emulated`` runs the kernel's own walk (splits,
partials, combine) in plain PyTorch, as JAX's interpret mode runs its
kernel; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import CudaKernel
from .attention import KERNEL_DTYPES, KERNEL_HEAD_DIMS, NEG_INF

MAX_GROUP = 16       # query heads per kv head the kernel holds
MAX_BLOCK_SIZE = 64  # pool block size the kernel holds
MAX_SPLIT_BLOCKS = 1024  # table entries one CTA holds in shared memory
H100_SMS = 132
CTAS_PER_SM = 2      # the split policy's target

# C entry: csrc/paged_decode.cu `paged_decode` (one kernel launch a call)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
PAGED_DECODE = CudaKernel(
    "paged_decode", "paged_decode",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _F, _I, _I, _P],
)
# per (device, stream): the kernel's arrival counters, one per (slot, kv
# head); zero between calls (the last CTA of each puts its counter back to
# 0), and calls on one stream never overlap
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def paged_splits(slots: int, kv_heads: int, table_blocks: int,
                 sm_count: int = H100_SMS) -> int:
    """Splits of each (slot, kv head)'s blocks: enough CTAs for about
    CTAS_PER_SM on each SM, at most one split per table block, and at
    least enough that no CTA holds more than MAX_SPLIT_BLOCKS table
    entries. It reads only shapes, so it costs the host no sync."""
    fill = max(1, (CTAS_PER_SM * sm_count) // max(1, slots * kv_heads))
    return max(1, -(-table_blocks // MAX_SPLIT_BLOCKS),
               min(table_blocks, fill))


def _attended(length: int, table_blocks: int, block_size: int,
              window: int) -> Tuple[int, int]:
    """The positions [first, end) the kernel reads for a row: the whole
    table for a row of length 0, else from the window's first to the
    row's length, never past the table."""
    if length == 0:
        return 0, table_blocks * block_size
    first = max(0, length - window) if window > 0 else 0
    return first, min(length, table_blocks * block_size)


def paged_split_ranges(
    length: int, table_blocks: int, block_size: int, window: int,
    splits: int,
) -> List[Tuple[int, int]]:
    """The kernel's cut of one row (``split_range`` in paged_decode.cu):
    the logical blocks [b0, b1) of each split. The row's attended blocks,
    from the window's first to ceil(len / bs) (all of the table for a row
    of length 0), go in ``splits`` contiguous ranges of equal size, the
    last ones shorter or empty."""
    bs = block_size
    first, end = _attended(length, table_blocks, bs, window)
    j_lo = first // bs
    j_hi = max(j_lo, -(-end // bs))
    chunk = -(-(j_hi - j_lo) // splits)
    out = []
    for i in range(splits):
        b0 = min(j_hi, j_lo + i * chunk)
        out.append((b0, min(j_hi, b0 + chunk)))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for calls on ``stream`` of
    ``device``, reused by each of them."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


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
    item = q.element_size()
    if any((x.data_ptr() | x.stride(0) * item | x.stride(1) * item
            | x.stride(2) * item) % 16 for x in (pool_k, pool_v)):
        raise ValueError("paged kernel reads 16-byte aligned pool rows")
    splits = paged_splits(slots, kv_heads, nb, _sm_count(q.device.index))
    out = torch.empty((slots, n, h), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if splits > 1:
            part = torch.empty(slots * n * splits * (h + 2),
                               dtype=torch.float32, device=q.device)
            counters = _counters(q.device, stream, slots * kv_heads)
        else:
            part = counters = out       # not read with one split
        PAGED_DECODE(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), KERNEL_DTYPES[q.dtype],
            slots, n, kv_heads, h,
            nb, bs, q.stride(0), q.stride(1),
            pool_k.stride(0), pool_k.stride(1), pool_k.stride(2),
            table.stride(0), 1.0 / math.sqrt(h), int(window), splits, stream,
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
    A row of length 0 attends nothing and gets what the JAX kernel gives
    it: the mean of V over all nb * bs positions of its table (every
    score is NEG_INF, so every p is 1)."""
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


def paged_decode_attention_emulated(
    q, pool_k, pool_v, table, lengths, kv_heads: int, window: int = 0,
    splits: Optional[int] = None,
):
    """Plain emulation of ``csrc/paged_decode.cu``'s walk, in the kernel's
    order: for each (slot, split) of its grid (all kv heads at once), the
    blocks of ``paged_split_ranges``'s range and no others, read straight
    through the table; scores over whole blocks, with the positions
    outside the attended range masked (and their K and V taken as zeros,
    as the kernel never loads them); the split's partial (m, l, acc) in
    f32; then the combine, each partial rescaled by exp(m_i - m) and the
    sum divided by max(l, 1e-30). A row of length 0 reads its whole table
    with every score equal (the mean of V, as JAX gives). Empty splits
    carry (NEG_INF, 0, 0) in the kernel and add nothing, so they are
    skipped. ``splits`` None: the policy's choice on an H100.

    The counterpart of JAX's ``paged_decode_attention(..., interpret=
    True)``: the kernel's own walk, run plainly. Nothing on the main path
    calls it; it holds the split-K combine's arithmetic on the CPU, and
    ``serving_proxy.xla_measured_costs`` tallies it. Its matmuls do
    4 * bs * n * h flops for each block a split streams."""
    _check(q, pool_k, pool_v, table, lengths, kv_heads)
    slots, n, h = q.shape
    g = kv_heads
    r = n // g
    nb, bs = table.shape[1], pool_k.shape[1]
    if splits is None:
        splits = paged_splits(slots, g, nb)
    scale = 1.0 / math.sqrt(h)
    rows = []
    for s, length in enumerate(lengths.tolist()):
        first, end = _attended(length, nb, bs, window)
        qs = q[s].reshape(g, r, h).float()
        ms, ls, accs = [], [], []
        for b0, b1 in paged_split_ranges(length, nb, bs, window, splits):
            if b0 == b1:
                continue
            blocks = table[s, b0:b1].long()
            pos = torch.arange(b0 * bs, b1 * bs, device=q.device)
            keep = (pos >= first) & (pos < end)                  # [P]
            k = pool_k[blocks].reshape(-1, g, h).float()         # [P, g, h]
            v = pool_v[blocks].reshape(-1, g, h).float()
            k = torch.where(keep[:, None, None], k, 0.0)
            v = torch.where(keep[:, None, None], v, 0.0)
            scores = torch.matmul(qs, k.permute(1, 2, 0)) * scale  # [g,r,P]
            if length == 0:
                scores = torch.zeros_like(scores)
            scores = torch.where(keep, scores, NEG_INF)
            m = scores.amax(-1, keepdim=True)                    # [g, r, 1]
            p = torch.where(keep, torch.exp(scores - m), 0.0)
            ms.append(m)
            ls.append(p.sum(-1, keepdim=True))
            accs.append(torch.matmul(p, v.permute(1, 0, 2)))     # [g, r, h]
        m = torch.stack(ms)                                      # [k, g, r, 1]
        w = torch.exp(m - m.amax(0))
        l_sum = (torch.stack(ls) * w).sum(0)
        acc = (torch.stack(accs) * w).sum(0)
        rows.append((acc / l_sum.clamp_min(1e-30)).reshape(n, h))
    return torch.stack(rows).to(q.dtype)


def kernel_traffic(
    slots: int, table_blocks: int, block_size: int, kv_heads: int,
    head_dim: int, itemsize: int, n_heads: Optional[int] = None,
    lengths: Optional[Sequence[int]] = None, window: int = 0,
    splits: Optional[int] = None,
) -> dict:
    """Device-memory traffic and arithmetic of one call of the Hopper
    kernel, from its grid: (slots, g, splits) CTAs (``splits`` None: the
    policy's choice on an H100); each reads its length, its table range,
    the attended K and V rows of its kv head in that range (each once,
    from the window's first block to ceil(len / bs), never past the
    table; a row of length 0 reads its whole table) and its r query rows.
    With one split it writes r output rows; with more it writes r
    partials of (m, l, acc[h]) in f32, which the last CTA of its (slot, kv
    head) reads back before it writes the output.

    ``bytes`` counts each input byte the function needs once and each
    output byte once (the bound's count); ``partial_bytes`` is the
    partials' write and read-back, and ``kernel_bytes`` all that the
    launch moves (with the query rows read once per split). ``lengths``
    None counts every table entry as full (the most one call can read)."""
    g, h, bs, nb = kv_heads, head_dim, block_size, table_blocks
    n = n_heads or g
    if splits is None:
        splits = paged_splits(slots, g, nb)
    if lengths is None:
        lengths = [nb * bs] * slots
    positions = blocks = 0
    for ln in lengths:
        if int(ln) == 0:
            positions += nb * bs
            blocks += nb
            continue
        ln = min(int(ln), nb * bs)
        first = max(0, ln - window) if window > 0 else 0
        positions += ln - first
        if ln > first:
            blocks += -(-ln // bs) - first // bs
    kv_read = positions * g * h * itemsize * 2
    q_row, o_row = slots * n * h * itemsize, slots * n * h * itemsize
    index = slots * 4 + blocks * 4
    partial = 2 * slots * n * splits * (h + 2) * 4 if splits > 1 else 0
    return {
        "grid": (slots, g, splits),
        "blocks_streamed": blocks * g,
        "reads_per_block": 1,
        "positions_attended": positions,
        "kv_bytes_read": kv_read,
        "bytes": kv_read + q_row + o_row + index,
        "partial_bytes": partial,
        "kernel_bytes": (kv_read + splits * q_row + o_row
                         + (slots * splits + blocks) * g * 4 + partial),
        "flops": 4 * positions * (n // g) * g * h,
    }
