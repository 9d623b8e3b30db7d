"""Ring attention, PyTorch port: attention with the sequence axis sharded
over the mesh's "sp" ranks.

Counterpart of ``elastic_tpu_agent/workloads/ring_attention.py``, with
JAX's schedule: each sp shard holds one contiguous, equal sequence chunk
of q/k/v; k/v chunks rotate around the ring and the partial outputs merge
by the log-sum-exp rule. Because chunks are contiguous and equal, the
chunk-offset causal mask collapses to three block cases:

  future chunk (k_off > q_off)  -> fully masked: no kernel at all
  diagonal     (k_off == q_off) -> causal block
  past chunk   (k_off < q_off)  -> non-causal block

A block runs the port's flash kernels (``attention.py``: the forward, and
the dK/dV and dQ kernels in the backward) wherever ``supports_flash``
admits the chunk's shape, and the materialised-scores einsum
``_block_attn`` otherwise. Grouped kv heads rotate at their own width.

**The exchange** is a small interface with two implementations:

- ``ProcessGroupRing`` (the real path): one shard per rank; a rotation
  sends to the next sp rank and receives from the previous one in one
  ``dist.batch_isend_irecv`` (every send paired with its recv, the same op
  order on every rank). JAX's ``ppermute``.
- ``StackedRing``: every sp shard in one process along a leading axis; a
  rotation is a roll of that axis. This is how ``jax.vmap(...,
  axis_name="sp")`` runs the same JAX function; tests and the card use it
  to run the schedule without several ranks. No entry point picks it by
  default.

Both hold their shards along a leading axis (one entry for a rank), so
the schedule is written once; a step's past-chunk blocks of all local
shards run as one kernel call.

**The backward** is written out (``ring_backward``, behind a
``torch.autograd.Function``), not derived through the rotation: each
block's gradients come from the backward kernels with the merged lse and ``delta = rowsum(dO * O)`` of
the merged output, so no block's own lse or output is kept. dQ stays
home; the dK/dV accumulators (f32) travel with their k/v chunk and go
home with one more rotation after the last step. Every rank performs the
same rotations whatever its blocks skip, so no rank waits on a peer that
skipped an exchange.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .attention import (
    NEG_INF,
    FlashConfig,
    _flash_fwd,
    _repeat_kv,
    _tma_aligned,
    flash_bwd_delta,
    flash_bwd_dkdv,
    flash_bwd_dkdv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    supports_flash,
)


class ProcessGroupRing:
    """The ring over a process group: this rank holds shard ``rank`` of
    ``size``; ``rotate`` passes every tensor to the next rank and returns
    the previous rank's."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.indices = (rank,)
        self._next = dist.get_global_rank(group, (rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (rank - 1) % self.size)

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.size == 1:
            return list(tensors)
        tensors = [t.contiguous() for t in tensors]
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, buf) in enumerate(zip(tensors, out)):
            ops.append(dist.P2POp(dist.isend, t, self._next, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, self._prev, self.group,
                                  tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class StackedRing:
    """All ``size`` shards in one process along a leading axis; shard i
    receives shard i - 1's tensors (a roll by one)."""

    def __init__(self, size: int):
        self.size = size
        self.indices = tuple(range(size))

    def rotate(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.roll(t, 1, dims=0) for t in tensors]


Ring = Union[ProcessGroupRing, StackedRing]


def _block_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Einsum fallback: a q chunk against one k/v chunk with the [sq, sk]
    scores materialised (JAX ``_block_attn``; ``causal`` only on the
    diagonal, where the offsets are equal). q [b, s, n, h], k/v
    [b, s, g, h] -> (o [b, s, n, h] normalised within the chunk, lse
    [b, n, s] f32)."""
    n = q.shape[2]
    k, v = _repeat_kv(k, n), _repeat_kv(v, n)
    logits = torch.einsum("bsnh,btnh->bnst", q, k).float() * scale
    if causal:
        s, t = logits.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    return torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v), lse


def _past(ring: Ring, t: int, causal: bool) -> int:
    """The first local position whose step-t chunk is a past one (its
    kv chunk came from shard index - t >= 0); all of them when not
    causal. Indices are sorted, so the past positions are a suffix."""
    if not causal:
        return 0
    return sum(1 for i in ring.indices if i < t)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:])


def ring_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Ring,
    causal: bool, cfg: FlashConfig, use_flash: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring's forward on the stacked chunks [m, b, s, n, h] (k/v at
    g | n heads): (o in q's dtype, the merged lse [m, b, n, s] f32).
    ``cfg`` carries the scale; ``use_flash`` picks the flash kernel (its
    plain version on the CPU) or ``_block_attn`` for the blocks."""
    m, b, s, n, h = q.shape

    def block(sel, kt, vt, blk_causal):
        args = (_flat(q[sel]), _flat(kt[sel]), _flat(vt[sel]))
        if use_flash:
            o, lse = _flash_fwd(
                *args, FlashConfig(causal=blk_causal, sm_scale=cfg.sm_scale))
        else:
            o, lse = _block_attn(*args, cfg.sm_scale, blk_causal)
        return o.float().view(-1, b, s, n, h), lse.view(-1, b, n, s)

    o, lse = block(slice(None), k, v, causal)
    kt, vt = k, v
    for t in range(1, ring.size):
        kt, vt = ring.rotate([kt, vt])
        lo = _past(ring, t, causal)
        if lo == m:
            continue                     # every local chunk is a future one
        ob, lb = block(slice(lo, m), kt, vt, False)
        new = torch.logaddexp(lse[lo:], lb)
        w_old = torch.exp(lse[lo:] - new).transpose(-1, -2)[..., None]
        w_new = torch.exp(lb - new).transpose(-1, -2)[..., None]
        o[lo:] = o[lo:] * w_old + ob * w_new
        lse[lo:] = new
    return o.to(q.dtype), lse


def ring_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, ring: Ring, causal: bool,
    cfg: FlashConfig, use_flash: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the ring from its forward's (q, k, v, out, lse) and
    the output cotangent ``do``, all stacked as ``ring_forward``'s: every
    block's gradients from the backward kernels (their plain versions on
    the CPU; the plain ones for ``_block_attn`` blocks) with the merged lse
    and delta = rowsum(do * out); dK/dV accumulate in f32 while they
    travel with their chunk, and go home with one more rotation."""
    m, b, s, n, h = q.shape
    do = do.contiguous()
    if do.dtype == torch.bfloat16 and not _tma_aligned(do):
        do = do.clone()
    delta = flash_bwd_delta(_flat(out), _flat(do)).view(m, b, n, s)
    if use_flash:
        dkdv, dq_of = flash_bwd_dkdv, flash_bwd_dq
    else:
        dkdv, dq_of = flash_bwd_dkdv_plain, flash_bwd_dq_plain
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkt = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvt = torch.zeros_like(dkt)
    kt, vt = k, v
    for t in range(ring.size):
        if t:
            kt, vt, dkt, dvt = ring.rotate([kt, vt, dkt, dvt])
        lo = 0 if t == 0 else _past(ring, t, causal)
        if lo == m:
            continue
        sel = slice(lo, m)
        args = (_flat(q[sel]), _flat(kt[sel]), _flat(vt[sel]),
                _flat(do[sel]), _flat(lse[sel]), _flat(delta[sel]),
                FlashConfig(causal=causal and t == 0, sm_scale=cfg.sm_scale))
        dk_b, dv_b = dkdv(*args)
        dq[sel] += dq_of(*args).float().view(-1, b, s, n, h)
        dkt[sel] += dk_b.float().view(dkt[sel].shape)
        dvt[sel] += dv_b.float().view(dvt[sel].shape)
    if ring.size > 1:
        dkt, dvt = ring.rotate([dkt, dvt])  # each accumulator home
    return dq.to(q.dtype), dkt.to(k.dtype), dvt.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """o = ring attention of the stacked chunks [m, b, s, n, h]."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, cfg, use_flash):
        out, lse = ring_forward(q, k, v, ring, causal, cfg, use_flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, causal, cfg, use_flash)
        return out

    @staticmethod
    def backward(ctx, do):
        return (*ring_backward(*ctx.saved_tensors, do, *ctx.args),
                None, None, None, None)


def resolve(q, sm_scale=None, flash=None) -> Tuple[FlashConfig, bool]:
    """(the blocks' config with its scale filled in, whether blocks run
    the flash kernels): ``flash`` None = wherever the shape gate admits
    the chunk, False = the einsum fallback, or an explicit FlashConfig."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    cfg = flash if isinstance(flash, FlashConfig) else FlashConfig()
    if sm_scale is None and cfg.sm_scale is not None:
        scale = cfg.sm_scale
    if cfg.window:
        raise ValueError("ring attention has no sliding window")
    use = flash is not False and supports_flash(q.shape[-3], q.shape[-1])
    return FlashConfig(sm_scale=scale), use


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring: Ring,
    causal: bool = True, sm_scale: Optional[float] = None,
    flash: Union[FlashConfig, bool, None] = None,
) -> torch.Tensor:
    """Local view: this rank's chunks [b, s_loc, n, h] (k/v may carry
    g | n heads) over a ``ProcessGroupRing``, or every chunk stacked
    [sp, b, s_loc, n, h] over a ``StackedRing``; returns the output chunk(s)
    in the same layout. Differentiable in q, k and v."""
    cfg, use_flash = resolve(q, sm_scale, flash)
    stacked = isinstance(ring, StackedRing)
    if stacked and q.shape[0] != ring.size:
        raise ValueError(f"stacked q {tuple(q.shape)}: want {ring.size} "
                         "chunks on the leading axis")
    q, k, v = (x.contiguous() if stacked else x[None].contiguous()
               for x in (q, k, v))
    out = _RingAttention.apply(q, k, v, ring, causal, cfg, use_flash)
    return out if stacked else out[0]


def ring_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
    causal: bool = True, sm_scale: Optional[float] = None,
    flash: Union[FlashConfig, bool, None] = None,
) -> torch.Tensor:
    """The ``[b, s, n, h]`` entry over a mesh: q/k/v are this rank's local
    shards (b on "dp", s on "sp", heads on "tp", as JAX's ``P("dp", "sp",
    "tp", None)``), and the ring runs over the mesh's "sp" group."""
    return ring_attention(q, k, v, ProcessGroupRing(mesh.get_group("sp")),
                          causal, sm_scale, flash)


def ring_attention_stacked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp: int,
    causal: bool = True, sm_scale: Optional[float] = None,
    flash: Union[FlashConfig, bool, None] = None,
) -> torch.Tensor:
    """The whole sequence [b, s, n, h] cut into ``sp`` contiguous chunks,
    run through the ring schedule in this process (``StackedRing``), and
    put back together: the function of ``ring_attention_sharded`` over an
    sp mesh, for tests and single-card checks."""
    b, s = q.shape[:2]
    if s % sp:
        raise ValueError(f"sequence {s} does not split into {sp} chunks")

    def cut(x):
        return x.reshape(b, sp, s // sp, *x.shape[2:]).transpose(0, 1)

    out = ring_attention(cut(q), cut(k), cut(v), StackedRing(sp), causal,
                         sm_scale, flash)
    return out.transpose(0, 1).reshape(q.shape)
