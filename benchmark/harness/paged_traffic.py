"""Frozen copy of the paged-decode kernel's traffic model.

Copied from ``elastic_tpu_agent_torch/workloads/paged_attention.py``
(``paged_splits``, ``kernel_traffic``) so that the yardstick cannot move
with the program: the bound of ``paged_decode_roofline`` counts, for each
launch, each input byte the attention needs once and each output byte
once, and 4 flops per attended position, query head and head element.
A test holds this copy equal to the program's function."""

from __future__ import annotations

from typing import Optional, Sequence

MAX_SPLIT_BLOCKS = 1024
H100_SMS = 132
CTAS_PER_SM = 2


def paged_splits(slots: int, kv_heads: int, table_blocks: int,
                 sm_count: int = H100_SMS) -> int:
    fill = max(1, (CTAS_PER_SM * sm_count) // max(1, slots * kv_heads))
    return max(1, -(-table_blocks // MAX_SPLIT_BLOCKS),
               min(table_blocks, fill))


def kernel_traffic(
    slots: int, table_blocks: int, block_size: int, kv_heads: int,
    head_dim: int, itemsize: int, n_heads: Optional[int] = None,
    lengths: Optional[Sequence[int]] = None, window: int = 0,
    splits: Optional[int] = None,
) -> dict:
    """Bytes and flops of one launch over ``slots`` rows of ``lengths``
    valid positions each (see the module docstring)."""
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
