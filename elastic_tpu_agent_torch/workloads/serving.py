"""Continuous-batching serving engine over a paged KV cache, PyTorch port.

Counterpart of the core of ``elastic_tpu_agent/workloads/serving.py``:
fixed decode slots that requests join and leave mid-flight, a KV block
pool [L, n_blocks, block, g, h] with a per-slot block table, bucketed
prefill, chunked prefill through ``enqueue``, per-request sampling and
stop tokens. Streams are pinned token-exact against the JAX engine.

Two decode paths, as in the JAX engine:
- the gather path gathers the live rows' blocks into a dense transient
  view, runs the shared ``generate._forward_chunk`` with per-row
  positions, and writes the one new position per slot back to its block;
- the kernel path (``paged_kernel``) writes each layer's new K/V entry
  straight into its pool block and attends through the Hopper paged-decode
  kernel (``paged_attention.py``): no gathered copy, each attended block
  read once. ``paged_kernel=None`` turns it on for a CUDA device (the JAX
  package's traffic model puts the kernel's KV-byte saving at about 3x
  whatever the shape). On CPU tensors ``paged_kernel=True`` runs the
  kernel's plain version, so tests can pin the two paths against each
  other.

Where JAX donates the pool buffers to each compiled program, the port
updates the pool tensors in place (``index_put_``). The per-(bucket,
greedy) compiled-program caches have no counterpart: PyTorch runs eagerly.

``kv_int8`` stores the pool as ``{"q": int8, "s": f32 [..., 1]}``
(quantized on every write, dequantized after every gather) and runs the
gather path, as the JAX engine does. One difference: the JAX gather step
feeds the f32 dequantized view to a ``cfg.dtype`` model, and jnp's type
promotion then carries the rest of that step in f32; the port rounds the
view to ``cfg.dtype``, as the JAX chunk-prefill program does. In f32 the
two are the same computation.

MoE models take the JAX engine's capacity policy: prefill and prefill
chunks route with the training factor (a bucket's padded tail takes
capacity slots too), decode steps are drop-free. ``recorder=`` (a
``telemetry.FlightRecorder``) gets a ``serving_admit`` record per
admission and a ``serving_step`` record per step; ``lifecycle=`` (a
``lifecycle.LifecycleWatcher``) refuses admissions with ``ValueError``
once the node signals a drain.

The engine's sampling generator advances where the JAX engine splits its
key: at each admission, at a prefill's final chunk and on every plain
step, whether or not a live row samples, so that a request's draws do not
depend on its neighbours' settings.

Options of the JAX engine that belong to later slices raise
``NotImplementedError``: the prefix cache, tensor-parallel meshes, shared
pools and prefill/decode roles, speculative decoding and the request
observatory.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .generate import (
    KVCache,
    _chunk_mlp,
    _forward_chunk,
    _qkv,
    _sample_rowwise,
)
from .paged_attention import paged_decode_attention
from .quantize import embed_lookup, quantize_kv, wdense
from .request_obs import normalize_slo
from .transformer import ModelConfig, _check_device, _rmsnorm, as_device, rope

# physical block 0 is the JUNK block: never allocated, the write target
# for frozen slots and the gather source for empty table entries — its
# contents are garbage by design and masked everywhere they could be read
_JUNK = 0

# JAX-engine options that come with later slices, with their defaults
_LATER_OPTIONS = {
    "prefix_cache": (False, "the prefix cache"),
    "prefix_cache_blocks": (None, "the prefix cache"),
    "mesh": (None, "multi-GPU serving"),
    "role": ("both", "prefill/decode roles over a shared pool"),
    "pool": (None, "prefill/decode roles over a shared pool"),
    "draft_params": (None, "speculative decoding"),
    "draft_cfg": (None, "speculative decoding"),
    "gamma": (4, "speculative decoding"),
    "observatory": (None, "request observability"),
}


def gather_bucket(needed_blocks: int, max_blocks: int) -> int:
    """Power-of-two gather-width bucketing, capped at max_blocks."""
    b = 1
    while b < needed_blocks:
        b *= 2
    return min(b, max_blocks)


# -- pool representation helpers ------------------------------------
#
# The KV pool is a tensor [L, n_blocks, bs, g, h] or (kv_int8) the dict
# {"q": int8 same shape, "s": f32 [..., 1] per-position scales}. Every
# pool read and write goes through these helpers: quantize on scatter,
# dequantize after the gather.


def _pool_empty(shape, dtype, device, kv_int8: bool = False):
    if not kv_int8:
        return torch.zeros(shape, dtype=dtype, device=device)
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=device),
        "s": torch.zeros(
            shape[:-1] + (1,), dtype=torch.float32, device=device),
    }


def _pool_shape(pool):
    return tuple((pool["q"] if isinstance(pool, dict) else pool).shape)


def _pool_set(pool, idx, val: torch.Tensor) -> None:
    """pool[idx] = val, in place (the JAX form returns a new array); an
    int8 pool quantizes per position on the way down."""
    if isinstance(pool, dict):
        qv = quantize_kv(val)
        pool["q"][idx] = qv["q"]
        pool["s"][idx] = qv["s"]
    else:
        pool[idx] = val.to(pool.dtype)


def _pool_get(pool, idx) -> torch.Tensor:
    """pool[idx]; an int8 pool gathers int8 entries and scales and
    dequantizes after the gather (f32)."""
    if isinstance(pool, dict):
        return pool["q"][idx].float() * pool["s"][idx]
    return pool[idx]


class BlockAllocator:
    """Host-side pool bookkeeping: a free list plus per-block refcounts."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = np.zeros((n_blocks,), np.int32)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "KV block pool exhausted; release() a request or size "
                "the engine with more pool_blocks"
            )
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def share(self, bid: int) -> int:
        self._ref[bid] += 1
        return bid

    def drop(self, bid: int) -> None:
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    @property
    def used(self) -> int:
        """Blocks currently held (excludes the junk block)."""
        return self.n_blocks - 1 - len(self._free)


class ServingEngine:
    """Host-driven continuous-batching decoder over fixed slots and a
    paged KV block pool.

    >>> eng = ServingEngine(params, cfg, slots=4, max_len=256)
    >>> rid = eng.admit(prompt_tokens)       # prefill + first token
    >>> toks = eng.step()                    # {rid: token} per live req
    >>> eng.release(rid)                     # tokens; slot reusable

    admit() prefills synchronously; enqueue() spreads the prefill one
    block-sized chunk per step(), so decodes advance every step and the
    request activates when its last chunk lands. Requests are named by a
    monotonically increasing id, never by slot. A request that fills its
    row to max_len or emits one of its stop tokens is auto-finished; its
    stream stays retrievable via release()/stream().

    Runs on ``device`` ("cuda" unless the caller asks for "cpu"), where
    ``params`` must live.
    """

    def __init__(
        self,
        params: Dict,
        cfg: ModelConfig,
        slots: int = 4,
        max_len: int = 512,
        prompt_buckets: Sequence[int] = (16, 64, 256),
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        block_size: Optional[int] = None,
        pool_blocks: Optional[int] = None,
        paged_kernel: Optional[bool] = None,
        kv_int8: bool = False,
        recorder=None,
        lifecycle=None,
        device="cuda",
        **later,
    ):
        for name, value in later.items():
            if name not in _LATER_OPTIONS:
                raise TypeError(f"unexpected argument {name!r}")
            default, what = _LATER_OPTIONS[name]
            if value is not default and value != default:
                raise NotImplementedError(
                    f"{name}={value!r}: {what} comes with a later slice of "
                    "the port"
                )
        self.device = as_device(device)
        _check_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(sorted(set(prompt_buckets)))
        if not self.buckets or self.buckets[-1] > max_len:
            raise ValueError(
                f"prompt buckets {self.buckets} vs max_len {max_len}"
            )
        if cfg.pos == "learned" and cfg.max_seq < max_len:
            raise ValueError(f"cfg.max_seq {cfg.max_seq} < max_len {max_len}")
        self._sampling = (temperature, top_k, top_p)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        if block_size is None:
            # largest power of two dividing every prompt bucket and max_len
            g = math.gcd(max_len, *self.buckets)
            block_size = g & (-g)
        self.block_size = block_size
        if max_len % block_size or any(b % block_size for b in self.buckets):
            raise ValueError(
                f"block_size {block_size} must divide max_len "
                f"{max_len} and every prompt bucket {self.buckets}"
            )
        self.max_blocks = max_len // block_size
        if pool_blocks is None:
            # all slots at max_len plus one slot's headroom, plus junk
            pool_blocks = 1 + (slots + 1) * self.max_blocks
        self.pool_blocks = pool_blocks
        self._alloc = BlockAllocator(pool_blocks)
        self.prefilled_tokens_total = 0
        self.admitted_tokens_total = 0
        self.decode_steps_total = 0
        # optional MoeRoutingStats (moe.py): stats() reports it
        self.moe_stats = None
        self._recorder = recorder
        self._lifecycle = lifecycle
        self.kv_int8 = kv_int8
        pool_shape = (
            cfg.n_layers, pool_blocks, block_size, cfg.kv_heads, cfg.head_dim,
        )
        self._pool_k = _pool_empty(pool_shape, cfg.dtype, self.device, kv_int8)
        self._pool_v = _pool_empty(pool_shape, cfg.dtype, self.device, kv_int8)
        # logical->physical block map per slot; 0 = unmapped (junk)
        self._table = np.zeros((slots, self.max_blocks), np.int32)
        self._lengths = torch.zeros(
            (slots,), dtype=torch.int32, device=self.device
        )
        self._host_len = np.zeros((slots,), np.int64)
        self._last = torch.zeros(
            (slots,), dtype=torch.long, device=self.device
        )
        self._free: List[int] = list(range(slots))
        self._next_rid = 0
        self._slot_of: Dict[int, int] = {}        # live rid -> slot
        self._streams: Dict[int, List[int]] = {}  # rid -> tokens
        self._row_temp = np.zeros((slots,), np.float32)
        self._row_topk = np.zeros((slots,), np.int32)
        self._row_topp = np.zeros((slots,), np.float32)
        self._stop: Dict[int, frozenset] = {}
        # chunked admissions mid-prefill (enqueue()): FIFO of rids;
        # _settling holds slots whose request activated THIS step
        self._pending: List[int] = []
        self._pending_state: Dict[int, Dict] = {}
        self._settling: set = set()
        # why each finished rid stopped: "released" | "max_len" |
        # "stop_token" | "pool_exhausted"
        self.finish_reason: Dict[int, str] = {}
        if paged_kernel is None:
            paged_kernel = self.device.type == "cuda" and not kv_int8
        if paged_kernel and kv_int8:
            raise ValueError(
                "kv_int8 and paged_kernel are mutually exclusive: the paged "
                "kernel streams raw pool blocks; int8 pools dequantize on "
                "the gather path"
            )
        self.paged_kernel = bool(paged_kernel)

    # -- paging helpers ----------------------------------------------

    def _blocks_for(self, n_positions: int) -> int:
        """Logical blocks needed to hold positions [0, n_positions)."""
        return -(-n_positions // self.block_size)

    def _ensure_blocks(self, slot: int, n_positions: int) -> None:
        """Back positions [0, n_positions) of ``slot`` with pool blocks."""
        for j in range(self._blocks_for(n_positions)):
            if self._table[slot, j] == _JUNK:
                self._table[slot, j] = self._alloc.alloc()

    def _drop_row(self, slot: int) -> None:
        for j in range(self.max_blocks):
            bid = int(self._table[slot, j])
            if bid != _JUNK:
                self._alloc.drop(bid)
        self._table[slot, :] = _JUNK

    def _gather_bucket(self, needed_blocks: int) -> int:
        return gather_bucket(needed_blocks, self.max_blocks)

    @property
    def used_blocks(self) -> int:
        return self._alloc.used

    def stats(self) -> Dict:
        """Block-pool occupancy, prefill/decode accounting and, with
        ``moe_stats`` attached, the MoE routing ledger."""
        out = {
            "slots": self.slots,
            "live_requests": len(self._slot_of),
            "pending_prefills": len(self._pending),
            "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "used_blocks": self.used_blocks,
            "pool_occupancy": round(
                self.used_blocks / max(1, self.pool_blocks - 1), 4
            ),
            "prefilled_tokens_total": self.prefilled_tokens_total,
            "admitted_tokens_total": self.admitted_tokens_total,
            "decode_steps_total": self.decode_steps_total,
            "paged_kernel": self.paged_kernel,
            "kv_int8": self.kv_int8,
        }
        if self.moe_stats is not None:
            out["moe"] = self.moe_stats.stats()
        return out

    def _tensor(self, array, dtype=None) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(array), dtype=dtype, device=self.device
        )

    # -- device programs ---------------------------------------------

    def _gathered_view(self, table_b: torch.Tensor):
        """[slots, Bb] table -> dense [L, slots, Bb*bs, g, h] views of the
        pool in cfg.dtype (transient copies; bucket-bounded)."""
        L, _, bs, g, h = _pool_shape(self._pool_k)
        slots, Bb = table_b.shape
        flat = (slice(None), table_b.reshape(-1).long())
        kg = _pool_get(self._pool_k, flat).reshape(L, slots, Bb * bs, g, h)
        vg = _pool_get(self._pool_v, flat).reshape(L, slots, Bb * bs, g, h)
        return kg.to(self.cfg.dtype), vg.to(self.cfg.dtype)

    def _pick(self, logits, greedy, temp, tk, tp):
        """The step's tokens. The uniforms are drawn on every step, as the
        JAX engine splits its key on every step; greedy rows ignore
        them."""
        uniforms = torch.rand(
            logits.shape, generator=self._gen, device=logits.device
        )
        if greedy:
            return torch.argmax(logits, dim=-1)
        return _sample_rowwise(
            logits, None, temp, tk, tp, uniforms=uniforms
        )

    def _step_gather(self, table_b, active, greedy, temp, tk, tp, wblk, woff):
        """Gather-path decode step: every slot, active or not, in lockstep;
        frozen slots write to the junk block and keep token and length."""
        kg, vg = self._gathered_view(table_b)
        lengths, toks = self._lengths, self._last
        logits, cache = _forward_chunk(
            self.params, toks[:, None], KVCache(k=kg, v=vg), self.cfg,
            moe_drop_free=True, positions=lengths,
        )
        nxt = self._pick(logits[:, 0], greedy, temp, tk, tp)
        # the ONE written position per slot goes back to its pool block;
        # clip: a frozen slot's stale length can exceed the gathered width
        idx = lengths.long().clamp(max=kg.shape[2] - 1)
        rows = torch.arange(self.slots, device=self.device)
        at = (slice(None), wblk, woff)
        _pool_set(self._pool_k, at, cache.k[:, rows, idx])
        _pool_set(self._pool_v, at, cache.v[:, rows, idx])
        return nxt

    def _decode_forward_paged(self, table_b, wblk, woff):
        """One decode token per slot DIRECTLY against the pool: each layer
        writes its new K/V entry straight to the slot's block and attends
        through the paged kernel. Mirrors _forward_chunk's layer body
        (cache write and attention swapped for the pool forms); the
        stream-identity tests against the gather path guard the two."""
        cfg, params = self.cfg, self.params
        toks, lengths = self._last, self._lengths
        x = embed_lookup(params, toks[:, None], cfg.dtype)  # [s, 1, d]
        posmat = lengths.long()[:, None]                      # [s, 1]
        if cfg.pos == "learned":
            x = x + params["pos_embed"].to(cfg.dtype)[posmat]
        n_valid = (lengths + 1).to(torch.int32)  # incl. this step's write
        for i, layer in enumerate(params["layers"]):
            h = _rmsnorm(x, layer["ln1_scale"])
            q, k_c, v_c = _qkv(h, layer, cfg)
            if cfg.pos == "rope":
                q = rope(q, posmat, cfg.rope_theta)
                k_c = rope(k_c, posmat, cfg.rope_theta)
            _pool_set(self._pool_k, (i, wblk, woff), k_c[:, 0])
            _pool_set(self._pool_v, (i, wblk, woff), v_c[:, 0])
            attn = paged_decode_attention(
                q[:, 0], self._pool_k[i], self._pool_v[i], table_b,
                n_valid, cfg.kv_heads, window=cfg.window,
            )
            x = x + torch.einsum(
                "snh,nhd->sd", attn, wdense(layer, "wo", cfg.dtype)
            )[:, None]
            h2 = _rmsnorm(x, layer["ln2_scale"])
            x = x + _chunk_mlp(h2, layer, cfg, moe_drop_free=True)
        x = _rmsnorm(x, params["final_norm_scale"])
        logits = torch.einsum(
            "std,dv->stv", x, wdense(params, "lm_head", cfg.dtype)
        ).float()
        return logits[:, 0]

    def _step_kernel(self, table_b, active, greedy, temp, tk, tp, wblk, woff):
        """Kernel-path decode step: same results as _step_gather."""
        logits = self._decode_forward_paged(table_b, wblk, woff)
        return self._pick(logits, greedy, temp, tk, tp)

    def _prefill(self, bucket: int, padded, true_len: int, tkp, phys):
        """Single-row chunk forward over a scratch cache of the bucket's
        width, then scatter its blocks into the pool (phys[j] = the slot's
        block for logical block j, junk for the padded tail it does not
        need). Returns the first generated token."""
        cfg, bs = self.cfg, self.block_size
        nb = bucket // bs
        mini = KVCache.empty(cfg, 1, bucket, device=self.device)
        logits, mini = _forward_chunk(self.params, padded[None], mini, cfg)
        L, _, _, g, h = _pool_shape(self._pool_k)
        at = (slice(None), phys)
        _pool_set(self._pool_k, at, mini.k.reshape(L, nb, bs, g, h))
        _pool_set(self._pool_v, at, mini.v.reshape(L, nb, bs, g, h))
        return self._sample_one(logits[:, true_len - 1], tkp)

    def _sample_one(self, logits_row, tkp) -> int:
        temp, tk, tp = tkp
        return int(_sample_rowwise(
            logits_row, self._gen, [temp], [int(tk)], [tp]
        )[0])

    def _chunk_prefill(
        self, n_b: int, row_blocks, toks, start: int, wphys: int
    ):
        """One block-sized prefill CHUNK for a pending row: gather the
        row's first ``n_b`` blocks, run the chunk at positions
        [start, start+block), write the one block back. Returns the
        chunk's logits [block, vocab]."""
        cfg, bs = self.cfg, self.block_size
        L, _, _, g, h = _pool_shape(self._pool_k)
        ridx = (slice(None), row_blocks)
        kg = _pool_get(self._pool_k, ridx).reshape(L, 1, n_b * bs, g, h)
        vg = _pool_get(self._pool_v, ridx).reshape(L, 1, n_b * bs, g, h)
        cache = KVCache(
            k=kg.to(cfg.dtype), v=vg.to(cfg.dtype), length=start
        )
        logits, cache = _forward_chunk(self.params, toks[None], cache, cfg)
        at = (slice(None), wphys)
        _pool_set(self._pool_k, at, cache.k[:, 0, start:start + bs])
        _pool_set(self._pool_v, at, cache.v[:, 0, start:start + bs])
        return logits[0]

    def _pump_prefill(self) -> Dict[int, int]:
        """Advance the OLDEST pending admission by one chunk; on its final
        chunk, sample the first token and activate the row. Returns
        {rid: first_token} when a row activates, else {}."""
        rid = self._pending[0]
        st = self._pending_state[rid]
        slot, seq, total = st["slot"], st["seq"], st["total"]
        bs = self.block_size
        start = st["next_pos"]
        chunk = np.zeros((bs,), np.int64)
        avail = min(bs, total - start)
        chunk[:avail] = seq[start:start + avail]
        n_b = self._gather_bucket(self._blocks_for(start + bs))
        logits = self._chunk_prefill(
            n_b, self._tensor(self._table[slot, :n_b], torch.long),
            self._tensor(chunk), start, int(self._table[slot, start // bs]),
        )
        st["next_pos"] = start + bs
        if st["next_pos"] < total:
            return {}
        # final chunk: sample from the last REAL prompt position
        self._pending.pop(0)
        self._pending_state.pop(rid)
        first = self._sample_one(logits[(total - 1) - start][None], st["tkp"])
        self.prefilled_tokens_total += total
        self.admitted_tokens_total += total
        self._activate(rid, slot, total, first)
        if first in self._stop[rid]:
            self._finish(rid, "stop_token")
        return {rid: first}

    def _activate(self, rid: int, slot: int, total: int, first: int) -> None:
        self._lengths[slot] = total
        self._host_len[slot] = total
        self._last[slot] = first
        self._slot_of[rid] = slot
        self._streams[rid] = [first]

    # -- request surface ---------------------------------------------

    def _claim_admission(self, prompt, temperature, top_k, top_p,
                         need_bucket: bool):
        """Validate, claim a slot, resolve per-request sampling and map
        blocks, rolling back on failure. A draining lifecycle watcher
        refuses every admission."""
        if self._lifecycle is not None:
            self._lifecycle.poll()
            if getattr(self._lifecycle, "draining", False):
                # ValueError: the engine's admission-control type, so a
                # serving loop treats a drain refusal like a full engine
                raise ValueError(
                    "engine draining: the node signalled "
                    "ELASTIC_TPU_DRAIN — no new admissions; finish "
                    "in-flight streams (lifecycle.drain_serving) and ack"
                )
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        p = len(prompt)
        if p == 0:
            raise ValueError("empty prompt")
        bucket = None
        if need_bucket:
            bucket = next((b for b in self.buckets if b >= p), None)
            if bucket is None:
                raise ValueError(
                    f"prompt length {p} exceeds largest bucket "
                    f"{self.buckets[-1]}"
                )
        if p >= self.max_len:
            raise ValueError(
                f"prompt length {p} leaves no room to decode (max_len "
                f"{self.max_len})"
            )
        if not self._free:
            raise ValueError("no free slot; release() one first")
        slot = self._free.pop(0)
        d_temp, d_topk, d_topp = self._sampling
        temp = d_temp if temperature is None else float(temperature)
        tk = d_topk if top_k is None else int(top_k)
        tp = d_topp if top_p is None else float(top_p)
        self._row_temp[slot] = temp
        self._row_topk[slot] = tk
        self._row_topp[slot] = tp
        try:
            # the prompt plus the next decode write
            self._ensure_blocks(slot, p + 1)
        except RuntimeError as e:
            self._drop_row(slot)
            self._free.append(slot)
            self._free.sort()
            raise ValueError(str(e)) from e
        return prompt, p, bucket, slot, (temp, tk, tp)

    @torch.no_grad()
    def admit(
        self,
        prompt,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_tokens: Sequence[int] = (),
        slo: Optional[str] = None,
    ) -> int:
        """Prefill a prompt (1-D int sequence) into a free slot; returns
        the request id. The first generated token is already in
        stream(rid). temperature/top_k/top_p override the engine-wide
        defaults for this request; emitting any of ``stop_tokens``
        auto-finishes it (the stop token is part of the stream). ``slo``
        ("ttft" | "tpot" | "batch", default batch) is an accounting
        annotation the flight record carries; it never changes
        scheduling."""
        t0 = time.perf_counter() if self._recorder is not None else 0.0
        prompt, p, bucket, slot, tkp = self._claim_admission(
            prompt, temperature, top_k, top_p, need_bucket=True
        )
        padded = np.zeros((bucket,), np.int64)
        padded[:p] = prompt
        nb_mini = bucket // self.block_size
        nb_req = self._blocks_for(p + 1)
        phys = np.full((nb_mini,), _JUNK, np.int64)
        for j in range(min(nb_req, nb_mini)):
            phys[j] = self._table[slot, j]
        first = self._prefill(
            bucket, self._tensor(padded), p, tkp, self._tensor(phys)
        )
        self.prefilled_tokens_total += p
        self.admitted_tokens_total += p
        rid = self._next_rid
        self._next_rid += 1
        self._stop[rid] = frozenset(int(t) for t in stop_tokens)
        self._activate(rid, slot, p, first)
        if first in self._stop[rid]:
            self._finish(rid, "stop_token")
        if self._recorder is not None:
            self._recorder.record(
                "serving_admit", rid=rid, prompt_len=p, prefix_len=0,
                bucket=bucket,
                duration_ms=round((time.perf_counter() - t0) * 1000, 3),
                used_blocks=self.used_blocks, slo=normalize_slo(slo),
            )
        return rid

    def enqueue(
        self,
        prompt,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_tokens: Sequence[int] = (),
        slo: Optional[str] = None,
    ) -> int:
        """CHUNKED admission: claim a slot and blocks now, run the prefill
        one block-sized chunk per step(). The request's first token
        appears in the step() result that activates it. A pending rid can
        be cancelled with release() (returns [])."""
        prompt, p, _, slot, tkp = self._claim_admission(
            prompt, temperature, top_k, top_p, need_bucket=False
        )
        rid = self._next_rid
        self._next_rid += 1
        self._stop[rid] = frozenset(int(t) for t in stop_tokens)
        self._pending.append(rid)
        self._pending_state[rid] = dict(
            slot=slot, seq=prompt, total=p, next_pos=0, tkp=tkp,
        )
        return rid

    @torch.no_grad()
    def step(self) -> Dict[int, int]:
        """Advance every live request by one token; returns {rid: token}.
        One pending chunked prefill advances first; a row it activates
        sits this decode out and reports its first token instead. Rows
        that fill to max_len, emit a stop token or starve for pool blocks
        auto-finish (``finish_reason`` says which)."""
        t0 = time.perf_counter() if self._recorder is not None else 0.0
        activated = self._pump_prefill() if self._pending else {}
        self._settling = {
            self._slot_of[r] for r in activated if r in self._slot_of
        }
        try:
            out = {**activated, **self._step_plain()}
        finally:
            self._settling = set()
        if self._recorder is not None:
            self._recorder.record(
                "serving_step",
                duration_ms=round((time.perf_counter() - t0) * 1000, 3),
                emitted_tokens=len(out),
                live_requests=len(self._slot_of),
                pending_prefills=len(self._pending),
                used_blocks=self.used_blocks,
                pool_blocks=self.pool_blocks,
            )
        return out

    def _step_plain(self) -> Dict[int, int]:
        if not self._slot_of:
            return {}
        rid_of_slot = {
            s: r for r, s in self._slot_of.items() if s not in self._settling
        }
        for s in sorted(rid_of_slot):
            try:
                self._ensure_blocks(s, int(self._host_len[s]) + 1)
            except RuntimeError:
                self._finish(rid_of_slot[s], "pool_exhausted")
        live_slots = set(self._slot_of.values()) - self._settling
        if not live_slots:
            return {}
        live = sorted(live_slots)
        bs = self.block_size
        wblk = np.full((self.slots,), _JUNK, np.int64)
        woff = np.zeros((self.slots,), np.int64)
        for s in live:
            w = int(self._host_len[s])
            wblk[s] = self._table[s, w // bs]
            woff[s] = w % bs
        n_b = self._gather_bucket(
            max(self._blocks_for(int(self._host_len[s]) + 1) for s in live)
        )
        table_b = self._tensor(self._table[:, :n_b], torch.int32)
        active = self._tensor([s in live_slots for s in range(self.slots)])
        greedy = not (self._row_temp[live] > 0.0).any()
        step = self._step_kernel if self.paged_kernel else self._step_gather
        nxt = step(
            table_b, active, greedy, self._tensor(self._row_temp),
            self._tensor(self._row_topk), self._tensor(self._row_topp),
            self._tensor(wblk), self._tensor(woff),
        )
        # frozen slots keep their token and length
        self._last = torch.where(active, nxt, self._last)
        self._lengths = torch.where(active, self._lengths + 1, self._lengths)
        self._host_len[live] += 1
        self.decode_steps_total += 1
        out = {}
        toks = self._last.cpu().numpy()
        for rid, slot in list(self._slot_of.items()):
            if slot in self._settling:
                continue
            tok = int(toks[slot])
            self._streams[rid].append(tok)
            out[rid] = tok
            # a row at max_len-1 can't take another write
            if int(self._host_len[slot]) >= self.max_len - 1:
                self._finish(rid, "max_len")
            elif tok in self._stop[rid]:
                self._finish(rid, "stop_token")
        return out

    def _finish(self, rid: int, reason: str = "released") -> None:
        slot = self._slot_of.pop(rid)
        self.finish_reason[rid] = reason
        self._drop_row(slot)
        self._free.append(slot)
        self._free.sort()

    def stream(self, rid: int) -> List[int]:
        """Tokens generated so far; [] for a still-prefilling rid."""
        if rid in self._pending_state:
            return []
        return list(self._streams[rid])

    def release(self, rid: int) -> List[int]:
        """Finish a live request (freeing its slot and blocks) or collect
        an auto-finished one; returns its generated tokens. Releasing a
        PENDING enqueue() rid cancels its prefill and returns []."""
        if rid in self._pending_state:
            st = self._pending_state.pop(rid)
            self._pending.remove(rid)
            self._drop_row(st["slot"])
            self._free.append(st["slot"])
            self._free.sort()
            self._stop.pop(rid, None)
            return []
        if rid in self._slot_of:
            self._finish(rid)
        self._stop.pop(rid, None)
        self.finish_reason.pop(rid, None)
        return self._streams.pop(rid)
