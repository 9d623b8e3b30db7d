"""Continuous-batching serving engine over a paged KV cache, PyTorch port.

Counterpart of ``elastic_tpu_agent/workloads/serving.py``: fixed decode
slots that requests join and leave mid-flight, a KV block pool
[L, n_blocks, block, g, h] with a per-slot block table, bucketed prefill,
chunked prefill through ``enqueue``, per-request sampling and stop tokens.
Streams are pinned token-exact against the JAX engine.

Two decode paths, as in the JAX engine:
- the gather path gathers the live rows' blocks into a dense transient
  view, runs the shared ``generate._forward_chunk`` with per-row
  positions, and writes the one new position per slot back to its block;
- the kernel path (``paged_kernel``) writes each layer's new K/V entry
  straight into its pool block and attends through the Hopper paged-decode
  kernel (``paged_attention.py``): no gathered copy, each attended block
  read once. ``paged_kernel=None`` resolves through JAX's rule
  (``serving_proxy.recommend_paged_kernel``): on for a CUDA device, the
  engine's own float pool and no mesh, where the traffic model puts the
  kernel's KV-byte saving at about 3x whatever the shape. On CPU tensors
  ``paged_kernel=True`` runs the kernel's plain version, so tests can pin
  the two paths against each other.

Where JAX donates the pool buffers to each compiled program, the port
updates the pool tensors in place (``index_put_``). The per-(bucket,
greedy) compiled-program caches have no counterpart: PyTorch runs eagerly.

Shared prefixes, as in the JAX engine:
- ``prefix_cache=True`` publishes every full prompt block a prefill writes
  under a token hash chain (``prefix_cache.py``); an admission shares the
  longest cached chain (refcounts, no copy) and prefills only the tail,
  block by block through the chunk-prefill program. Only full blocks are
  shared and at least one prompt token is always prefilled, so a decode
  write never lands in a shared block. Cache-only blocks (refcount 1) are
  evicted LRU under pool pressure (``BlockAllocator.reclaim``).
- ``register_prefix`` prefills a prefix once; ``admit(prefix=)`` maps its
  full blocks and runs the prompt from the prefix's end in one scratch
  cache of width (padded prefix + bucket), writing back only the blocks
  the prompt wrote.

``SharedKVPool`` is one pool (allocator, prefix cache, tensors) under
several engines: a ``role="prefill"`` engine prefills and publishes
through the cache and frees its slot; a ``role="decode"`` engine adopts
the published blocks at its cache hit and decodes. ``publish_stream``/
``adopt_stream`` hand an open stream (blocks by refcount, cursor,
sampling and stop state) to a peer mid-decode, and
``lifecycle.drain_serving(handoff=True)`` publishes every live stream of a
draining engine. Shared-pool engines run the gather path, as JAX requires.

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
once the node signals a drain; ``observatory=`` (a
``request_obs.RequestObservatory``) keeps each request's phase partition.

The engine's sampling generator advances where the JAX engine splits its
key: at each admission, at a prefill's final chunk and on every plain
step, whether or not a live row samples, so that a request's draws do not
depend on its neighbours' settings.

Speculative mode (``draft_params``/``draft_cfg``/``gamma``), as in the JAX
engine: every step drafts ``gamma`` tokens per live slot with the draft
model over its own dense cache [L_d, slots, max_len, g_d, h_d], verifies
all slots' ``gamma + 1`` positions in ONE target chunk at per-row
positions over the gathered view (never the paged kernel), scatters all
of them back to the pool, and commits each row's accepted prefix and
correction (``speculative.accept_resample``). ``step()`` then returns a
list per request. Rows hold their cached length at every committed token
but the trailing ``last``, so a rejected tail is stale but masked and
later overwritten, both caches rolling back by length alone. A row within
``gamma`` of ``max_len`` makes the whole step fall back: a draft catch-up,
then a plain step (with ``paged_kernel`` on, the only spec-mode steps that
launch the paged kernel). The step draws its draft, accept and correction
uniforms for every slot on every spec step, whatever the rows'
temperatures. Greedy streams equal target-only greedy decoding; sampled
rows are per-request temperature only (top-k/top-p admissions raise).

``mesh`` (``partitioner.make_serving_mesh``) makes the engine
tensor-parallel, as JAX's: heads, the MLP and the vocabulary split over
the mesh's "mp" axis, and the pool its kv-head axis (``partitioner.py``).
The port runs it SPMD: every rank of the mesh runs the same engine on the
same requests, holding its shards of the params and its kv heads of the
pool; ``_forward_chunk(view=)`` all-reduces after ``wo`` and ``w2`` and
gathers the logits over "mp", so the host state (allocator, tables,
prefix cache, sampling generator) stays the same on every rank and
``used_blocks``, ``stats()`` and the streams equal the single-device
engine's. A mesh engine runs the gather path, as JAX's does; a shared
pool, ``paged_kernel=True`` and a draft model are refused with JAX's
messages.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .attention import FLASH_FWD
from .generate import (
    KVCache,
    _chunk_mlp,
    _forward_chunk,
    _learned_positions,
    _qkv,
    _sample_rowwise,
)
from .paged_attention import paged_decode_attention
from .partitioner import ServingPartitioner
from .prefix_cache import PrefixCache, chain_hashes
from .quantize import embed_lookup, quantize_kv, wdense
from .request_obs import normalize_slo
from .serving_proxy import recommend_paged_kernel
from .speculative import (
    SpecStats,
    accept_resample,
    probs_rowwise,
    sample_from_probs,
)
from .telemetry import SPANS
from .transformer import ModelConfig, _check_device, _rmsnorm, as_device, rope

# physical block 0 is the JUNK block: never allocated, the write target
# for frozen slots and the gather source for empty table entries — its
# contents are garbage by design and masked everywhere they could be read
_JUNK = 0

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
    """Host-side pool bookkeeping: a free list plus per-block refcounts
    (shared prefix blocks are held by several tables at once).

    ``reclaim`` (set by the engine when a prefix cache is on) is the
    pool-pressure hook: called with the number of blocks needed when the
    free list runs dry, it may evict cache-held refcount-1 blocks back
    onto the free list before alloc() declares exhaustion."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = np.zeros((n_blocks,), np.int32)
        self.reclaim: Optional[object] = None  # (n_blocks) -> freed

    def alloc(self) -> int:
        if not self._free and self.reclaim is not None:
            self.reclaim(1)
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


class SharedKVPool:
    """One paged KV block pool shared by several engines: the substrate of
    prefill/decode disaggregation. A ``role="prefill"`` engine writes
    prompt K/V into pool blocks and publishes them through the prefix
    cache; a ``role="decode"`` engine admits the same prompt, shares the
    published blocks (refcounts, no copy, no recompute), prefills only the
    tail of at least one token and decodes.

    Owns the allocator, the prefix cache (always on: it is the handoff
    channel) and the pool tensors on ``device``; attached engines read and
    write the tensors in place. Besides, two registries:
    - the request registry stitches a prefill-role request's observatory
      record to its decode-role admission (keyed by the prompt's block
      chain digests; un-adopted publications age out LRU);
    - the stream registry carries mid-stream handoffs
      (``ServingEngine.publish_stream``/``adopt_stream``): each record
      owns one refcount per block of its chain, so a published stream
      survives its source slot's release; overflow expires the oldest.
    Host-side driving is expected from one thread, as for one engine.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        block_size: int,
        pool_blocks: int,
        kv_int8: bool = False,
        prefix_cache_blocks: Optional[int] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.block_size = block_size
        self.pool_blocks = pool_blocks
        self.kv_int8 = kv_int8
        self.device = as_device(device)
        self.allocator = BlockAllocator(pool_blocks)
        self.prefix_cache = PrefixCache(
            self.allocator, block_size, max_blocks=prefix_cache_blocks
        )
        self.allocator.reclaim = self.prefix_cache.reclaim
        shape = (
            cfg.n_layers, pool_blocks, block_size, cfg.kv_heads, cfg.head_dim,
        )
        self.pool_k = _pool_empty(shape, cfg.dtype, self.device, kv_int8)
        self.pool_v = _pool_empty(shape, cfg.dtype, self.device, kv_int8)
        # admissions that mapped cached blocks some attached engine
        # published: on a decode-role engine, prefill->decode handoffs
        self.adoptions = 0
        self.adopted_tokens = 0
        self._request_registry: "OrderedDict[bytes, object]" = OrderedDict()
        self.max_registry_digests = 1024
        self.published_requests = 0
        self.adopted_requests = 0
        self._stream_registry: "OrderedDict[int, dict]" = OrderedDict()
        self._next_handoff_id = 0
        self.max_pending_streams = 256
        self.published_streams = 0
        self.adopted_streams = 0
        self.expired_streams = 0

    def publish_request(self, digests, record) -> None:
        """Publish a prefill-role request's observatory record under every
        digest of its block chain (the decode side may cover a shorter
        prefix than the publisher wrote, so any chain point adopts)."""
        if not digests:
            return
        for d in digests:
            self._request_registry[d] = record
            self._request_registry.move_to_end(d)
        self.published_requests += 1
        while len(self._request_registry) > self.max_registry_digests:
            self._request_registry.popitem(last=False)

    def adopt_request(self, digest):
        """Claim (and remove) the published record whose chain contains
        ``digest``; a publication is adopted at most once."""
        rec = self._request_registry.get(digest)
        if rec is None:
            return None
        for d in [k for k, v in self._request_registry.items() if v is rec]:
            del self._request_registry[d]
        self.adopted_requests += 1
        return rec

    def publish_stream(self, record: dict) -> int:
        """Register a mid-stream handoff record (it already holds one
        block refcount per entry of its chain). Overflow expires the
        oldest pending record: its block refs drop and its open
        observatory partition closes as ``handoff_expired``."""
        hid = self._next_handoff_id
        self._next_handoff_id += 1
        record["handoff_id"] = hid
        self._stream_registry[hid] = record
        self.published_streams += 1
        while len(self._stream_registry) > self.max_pending_streams:
            _, stale = self._stream_registry.popitem(last=False)
            for bid in stale.get("blocks", ()):
                self.allocator.drop(bid)
            stale_obs = stale.get("obs")
            if stale_obs is not None:
                stale_obs.owner.finish(stale_obs.uid, "handoff_expired")
            self.expired_streams += 1
        return hid

    def claim_stream(self, handoff_id: Optional[int] = None):
        """Claim (and remove) a pending handoff record, oldest first or by
        id; None when nothing is pending. The claimer inherits the
        record's block refcounts and must hand an unseatable record back
        through ``restore_stream``."""
        if handoff_id is None:
            if not self._stream_registry:
                return None
            _, rec = self._stream_registry.popitem(last=False)
        else:
            rec = self._stream_registry.pop(handoff_id, None)
            if rec is None:
                return None
        self.adopted_streams += 1
        return rec

    def restore_stream(self, record: dict) -> None:
        """Return a claimed but unseatable record to the front of the
        registry (it stays oldest) and un-count the claim."""
        hid = record["handoff_id"]
        self._stream_registry[hid] = record
        self._stream_registry.move_to_end(hid, last=False)
        self.adopted_streams -= 1

    @property
    def pending_streams(self) -> int:
        return len(self._stream_registry)

    def compatible_with(self, cfg: ModelConfig) -> bool:
        return (
            cfg.n_layers == self.cfg.n_layers
            and cfg.kv_heads == self.cfg.kv_heads
            and cfg.head_dim == self.cfg.head_dim
        )

    @property
    def used_blocks(self) -> int:
        return self.allocator.used

    def stats(self) -> Dict:
        return {
            "pool_blocks": self.pool_blocks,
            "used_blocks": self.used_blocks,
            "block_size": self.block_size,
            "adoptions": self.adoptions,
            "adopted_tokens": self.adopted_tokens,
            "published_requests": self.published_requests,
            "adopted_requests": self.adopted_requests,
            "published_streams": self.published_streams,
            "adopted_streams": self.adopted_streams,
            "expired_streams": self.expired_streams,
            "pending_streams": self.pending_streams,
            "prefix_cache": self.prefix_cache.stats(),
        }


def disaggregated_status(prefill: "ServingEngine",
                         decode: "ServingEngine") -> Dict:
    """Combined serving status of a prefill/decode pair over one
    SharedKVPool, in the shape of the agent's ``serving`` block: pool
    totals at the top level like a unified engine, per-role queue depths
    and the shared pool's adoption counters."""
    ps, ds = prefill.stats(), decode.stats()
    pool = prefill.shared_pool
    return {
        "slots": ps["slots"] + ds["slots"],
        "live_requests": ps["live_requests"] + ds["live_requests"],
        "pending_prefills": ps["pending_prefills"] + ds["pending_prefills"],
        "block_size": pool.block_size,
        "pool_blocks": pool.pool_blocks,
        "used_blocks": pool.used_blocks,
        "pool_occupancy": round(
            pool.used_blocks / max(1, pool.pool_blocks - 1), 4
        ),
        "prefilled_tokens_total": (
            ps["prefilled_tokens_total"] + ds["prefilled_tokens_total"]
        ),
        "admitted_tokens_total": (
            ps["admitted_tokens_total"] + ds["admitted_tokens_total"]
        ),
        "prefix_cache": pool.prefix_cache.stats(),
        "shared_pool": {
            "adoptions": pool.adoptions,
            "adopted_tokens": pool.adopted_tokens,
            "published_requests": pool.published_requests,
            "adopted_requests": pool.adopted_requests,
        },
        "roles": {
            "prefill": {
                "role": "prefill",
                "queue_depth": ps["pending_prefills"],
                "prefilled_tokens_total": ps["prefilled_tokens_total"],
            },
            "decode": {
                "role": "decode",
                "queue_depth": ds["live_requests"] + ds["pending_prefills"],
                "adopted_tokens_total": ds.get("adopted_tokens_total", 0),
            },
        },
    }


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

    ``prefix_cache``/``prefix_cache_blocks``, ``role``/``pool``,
    ``observatory`` and the speculative ``draft_params``/``draft_cfg``/
    ``gamma`` are the JAX engine's (module docstring); a speculative
    engine's step() returns {rid: [tokens...]}. Runs on
    ``device`` ("cuda" unless the caller asks for "cpu"), where ``params``
    (and a shared ``pool``) must live.
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
        draft_params: Optional[Dict] = None,
        draft_cfg: Optional[ModelConfig] = None,
        gamma: int = 4,
        paged_kernel: Optional[bool] = None,
        kv_int8: bool = False,
        recorder=None,
        lifecycle=None,
        prefix_cache: bool = False,
        prefix_cache_blocks: Optional[int] = None,
        role: str = "both",
        pool: Optional[SharedKVPool] = None,
        observatory=None,
        mesh=None,
        device="cuda",
    ):
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
        self._recorder = recorder
        self._lifecycle = lifecycle
        # the request observatory: share one across a disaggregated pair
        # so that stitched partitions live in one ledger
        self._observatory = observatory
        if (observatory is not None and recorder is not None
                and observatory.recorder is None):
            observatory.recorder = recorder
        self._obs_uid: Dict[int, int] = {}  # rid -> observatory uid
        # requests finished for pool exhaustion (the observatory's steps)
        self._evictions_total = 0

        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got {role!r}")
        if role != "both" and draft_params is not None:
            raise ValueError(
                "speculative serving does not support disaggregated "
                "prefill/decode roles"
            )
        self.role = role
        self.shared_pool = pool
        if pool is not None:
            if mesh is not None:
                raise ValueError(
                    "a SharedKVPool does not compose with a "
                    "tensor-parallel mesh yet (per-engine placement "
                    "would shard one pool two ways)"
                )
            if draft_params is not None:
                raise ValueError(
                    "speculative serving does not support a shared pool"
                )
            if paged_kernel:
                raise ValueError(
                    "paged_kernel=True does not compose with a shared pool "
                    "yet; shared-pool engines run the gather path"
                )
            paged_kernel = False
            if kv_int8 != pool.kv_int8:
                raise ValueError(
                    f"engine kv_int8={kv_int8} disagrees with the shared "
                    f"pool's kv_int8={pool.kv_int8}"
                )
            if not pool.compatible_with(cfg):
                raise ValueError(
                    "model config (n_layers/kv_heads/head_dim) does not "
                    "match the shared pool's"
                )
            if pool.device != self.device:
                raise ValueError(
                    f"the shared pool lives on {pool.device}, the engine "
                    f"on {self.device}"
                )
            if block_size is not None and block_size != pool.block_size:
                raise ValueError(
                    f"block_size {block_size} != shared pool's "
                    f"{pool.block_size}"
                )
            block_size = pool.block_size
            if pool_blocks is not None and pool_blocks != pool.pool_blocks:
                raise ValueError(
                    f"pool_blocks {pool_blocks} != shared pool's "
                    f"{pool.pool_blocks}"
                )

        # tensor-parallel serving: this rank's shards of the params and
        # its kv heads of the pool; the host bookkeeping is unchanged
        self.mesh = mesh
        self._part = ServingPartitioner(mesh, cfg)
        self._view = self._part.view()
        self.params = params = self._part.shard_params(params)

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
        if pool is not None:
            # the pool owns allocator, prefix cache and tensors; this
            # engine writes the tensors in place, so every attached engine
            # sees each update
            self.pool_blocks = pool.pool_blocks
            self._alloc = pool.allocator
            self._prefix_cache = pool.prefix_cache
            self._pool_k, self._pool_v = pool.pool_k, pool.pool_v
        else:
            if pool_blocks is None:
                # all slots at max_len plus one slot's headroom, plus junk
                pool_blocks = 1 + (slots + 1) * self.max_blocks
            self.pool_blocks = pool_blocks
            self._alloc = BlockAllocator(pool_blocks)
            self._prefix_cache = None
            if prefix_cache:
                self._prefix_cache = PrefixCache(
                    self._alloc, block_size, max_blocks=prefix_cache_blocks
                )
                self._alloc.reclaim = self._prefix_cache.reclaim
            pool_shape = (
                cfg.n_layers, pool_blocks, block_size,
                self._part.local_kv_heads(), cfg.head_dim,
            )
            self._pool_k = _pool_empty(
                pool_shape, cfg.dtype, self.device, kv_int8)
            self._pool_v = _pool_empty(
                pool_shape, cfg.dtype, self.device, kv_int8)
        if self.role == "prefill" and self._prefix_cache is None:
            raise ValueError(
                "role='prefill' publishes through the prefix cache; "
                "construct with prefix_cache=True or a SharedKVPool"
            )
        # real prompt tokens run through a prefill forward (tails only on
        # a cache hit), and admissions' tokens including shared prefixes
        self.prefilled_tokens_total = 0
        self.admitted_tokens_total = 0
        # admissions that mapped cached blocks, and the tokens they cover
        self.adoptions_total = 0
        self.adopted_tokens_total = 0
        self.stream_handoffs_out = 0
        self.stream_handoffs_in = 0
        # plain decode steps taken (each one kernel-path launch a layer)
        self.decode_steps_total = 0
        # optional MoeRoutingStats (moe.py): stats() reports it
        self.moe_stats = None
        # speculative-mode accounting (_step_speculative)
        self.spec_stats = SpecStats(rounds=0, drafted=0, accepted=0)
        if kv_int8 and draft_params is not None:
            raise ValueError(
                "speculative serving does not support kv_int8 (the "
                "accept/resample algebra is pinned to the float pool)"
            )
        self.kv_int8 = kv_int8
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
        # shared-pool engines keep each live request's real token history
        # (prefix + prompt, int32) so that publish_stream can rebuild its
        # block hash chain
        self._seq_tokens: Dict[int, np.ndarray] = {}
        # chunked admissions mid-prefill (enqueue()): FIFO of rids;
        # _settling holds slots whose request activated THIS step
        self._pending: List[int] = []
        self._pending_state: Dict[int, Dict] = {}
        self._settling: set = set()
        # registered prefixes: pid -> (pool block ids, length, tokens)
        self._prefixes: Dict[int, tuple] = {}
        self._next_prefix_id = 0
        # why each finished rid stopped: "released" | "max_len" |
        # "stop_token" | "pool_exhausted" | "prefilled" | "handoff"
        self.finish_reason: Dict[int, str] = {}
        if paged_kernel is None:
            # the traffic model's threshold (serving_proxy.py): on where
            # the kernel runs natively, off for CPU tensors
            paged_kernel = recommend_paged_kernel(
                cfg, interpret=self.device.type != "cuda", kv_int8=kv_int8,
                mesh=mesh, slots=slots, seq_len=max_len,
                block_size=self.block_size,
            )
        if paged_kernel and kv_int8:
            raise ValueError(
                "kv_int8 and paged_kernel are mutually exclusive: the paged "
                "kernel streams raw pool blocks; int8 pools dequantize on "
                "the gather path"
            )
        if paged_kernel and mesh is not None:
            raise ValueError(
                "paged_kernel does not compose with a tensor-parallel "
                "mesh yet; the TP engine runs the partitioned gather "
                "path"
            )
        self.paged_kernel = bool(paged_kernel)

        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.gamma = gamma
        if draft_params is not None:
            if mesh is not None:
                raise ValueError(
                    "speculative serving does not support a "
                    "tensor-parallel mesh yet (the draft's dense cache "
                    "is unsharded)"
                )
            if draft_cfg is None:
                raise ValueError("draft_params needs its draft_cfg")
            if cfg.vocab != draft_cfg.vocab:
                raise ValueError("draft/target vocabularies must match")
            if cfg.moe_experts or draft_cfg.moe_experts:
                raise ValueError("speculative serving supports dense models")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            if top_k or top_p:
                raise ValueError(
                    "speculative serving supports greedy/temperature "
                    "sampling only (no engine-wide top-k/top-p)"
                )
            if draft_cfg.pos == "learned" and draft_cfg.max_seq < max_len:
                raise ValueError(
                    f"draft_cfg.max_seq {draft_cfg.max_seq} < max_len "
                    f"{max_len}"
                )
            _check_device(draft_params, self.device)
            # the draft's dense cache: narrow by design, so paging it would
            # complicate the rollback by length for no real memory gain
            dshape = (draft_cfg.n_layers, slots, max_len,
                      draft_cfg.kv_heads, draft_cfg.head_dim)
            self._draft_k = torch.zeros(
                dshape, dtype=draft_cfg.dtype, device=self.device)
            self._draft_v = torch.zeros_like(self._draft_k)

    # -- paging helpers ----------------------------------------------

    def _blocks_for(self, n_positions: int) -> int:
        """Logical blocks needed to hold positions [0, n_positions)."""
        return -(-n_positions // self.block_size)

    def _take_blocks(self, n: int):
        """Yield ``n`` fresh pool blocks. The whole deficit is reclaimed
        from the prefix cache in one sweep up front (alloc's reclaim(1)
        stays the backstop). Lazy: a caller whose alloc raises keeps the
        blocks it took so far, and frees them itself."""
        deficit = n - len(self._alloc._free)
        if deficit > 0 and self._alloc.reclaim is not None:
            self._alloc.reclaim(deficit)
        for _ in range(n):
            yield self._alloc.alloc()

    def _ensure_blocks(self, slot: int, n_positions: int) -> None:
        """Back positions [0, n_positions) of ``slot`` with pool blocks."""
        need = [
            j for j in range(self._blocks_for(n_positions))
            if self._table[slot, j] == _JUNK
        ]
        for j, bid in zip(need, self._take_blocks(len(need))):
            self._table[slot, j] = bid

    def _drop_row(self, slot: int) -> None:
        for j in range(self.max_blocks):
            bid = int(self._table[slot, j])
            if bid != _JUNK:
                self._alloc.drop(bid)
        self._table[slot, :] = _JUNK

    def _free_slot(self, slot: int) -> None:
        self._free.append(slot)
        self._free.sort()

    def _gather_bucket(self, needed_blocks: int) -> int:
        return gather_bucket(needed_blocks, self.max_blocks)

    @property
    def used_blocks(self) -> int:
        return self._alloc.used

    @property
    def kv_block_bytes(self) -> int:
        """Bytes one pool block holds across K and V and every layer (an
        int8 pool counts its scales): the unit of the observatory's
        per-request KV attribution."""
        pk = self._pool_k
        parts = (pk["q"], pk["s"]) if isinstance(pk, dict) else (pk,)
        # the whole pool's, as the JAX engine's global arrays: a rank
        # holds 1/mp of the kv heads
        per = self._part.mp * sum(t.numel() * t.element_size()
                                  for t in parts)
        return int(2 * per // max(1, self.pool_blocks))

    def stats(self) -> Dict:
        """Block-pool occupancy, prefill accounting, the prefix cache's
        and the shared pool's counters and, with ``moe_stats`` attached,
        the MoE routing ledger: the JAX engine's keys."""
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
            "paged_kernel": self.paged_kernel,
            "kv_int8": self.kv_int8,
            "role": self.role,
            "adoptions_total": self.adoptions_total,
            "adopted_tokens_total": self.adopted_tokens_total,
            "stream_handoffs_out": self.stream_handoffs_out,
            "stream_handoffs_in": self.stream_handoffs_in,
        }
        if self._prefix_cache is not None:
            out["prefix_cache"] = self._prefix_cache.stats()
        if self.shared_pool is not None:
            sp = self.shared_pool.stats()
            out["shared_pool"] = {
                k: sp[k] for k in (
                    "adoptions", "adopted_tokens", "published_requests",
                    "adopted_requests", "published_streams",
                    "adopted_streams", "expired_streams", "pending_streams",
                )
            }
        if self.draft_params is not None:
            spec = self.spec_stats.stats()
            out["speculative"] = {
                "rounds": spec.pop("rounds"), "gamma": self.gamma, **spec}
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
            moe_drop_free=True, positions=lengths, view=self._view,
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
        stream-identity tests against the gather path guard the two.
        Rows may name the same physical prefix blocks (a cache hit); the
        write blocks are always private."""
        cfg, params = self.cfg, self.params
        toks, lengths = self._last, self._lengths
        x = embed_lookup(params, toks[:, None], cfg.dtype)  # [s, 1, d]
        posmat = lengths.long()[:, None]                      # [s, 1]
        if cfg.pos == "learned":
            x = x + _learned_positions(params, posmat, cfg.dtype)
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

    def _scratch_forward(self, padded, pref_blocks, pref_padded: int,
                         plen: int, phys):
        """Single-row chunk forward over a scratch cache of width
        pref_padded + len(padded): a registered prefix's blocks are
        gathered from the pool into its head (their forward is never
        recomputed; none for a bare prompt), the chunk runs from position
        ``plen``, and the scratch's blocks scatter into the pool: phys[j]
        is the pool block of the scratch's logical block j (junk over
        shared prefix blocks and past the request's need). Returns the
        chunk's logits."""
        L, _, bs, g, h = _pool_shape(self._pool_k)
        width = pref_padded + padded.shape[0]
        mini = KVCache(   # this rank's kv heads
            k=torch.zeros((L, 1, width, g, h), dtype=self.cfg.dtype,
                          device=self.device),
            v=torch.zeros((L, 1, width, g, h), dtype=self.cfg.dtype,
                          device=self.device))
        if pref_padded:
            pidx = (slice(None), self._tensor(pref_blocks, torch.long))
            for dst, pool in ((mini.k, self._pool_k),
                              (mini.v, self._pool_v)):
                dst[:, 0, :pref_padded] = _pool_get(pool, pidx).reshape(
                    L, pref_padded, g, h).to(dst.dtype)
        logits, mini = _forward_chunk(
            self.params, padded[None],
            KVCache(k=mini.k, v=mini.v, length=plen), self.cfg,
            view=self._view,
        )
        nb = mini.k.shape[2] // bs
        at = (slice(None), self._tensor(phys, torch.long))
        _pool_set(self._pool_k, at, mini.k.reshape(L, nb, bs, g, h))
        _pool_set(self._pool_v, at, mini.v.reshape(L, nb, bs, g, h))
        return logits

    def _sample_one(self, logits_row, tkp) -> int:
        temp, tk, tp = tkp
        return int(_sample_rowwise(
            logits_row, self._gen, [temp], [int(tk)], [tp]
        )[0])

    def _chunk_prefill(
        self, n_b: int, row_blocks, toks, start: int, wphys: int
    ):
        """One block-sized prefill CHUNK for one row: gather the row's
        first ``n_b`` blocks, run the chunk at positions
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
        logits, cache = _forward_chunk(self.params, toks[None], cache, cfg,
                                       view=self._view)
        at = (slice(None), wphys)
        _pool_set(self._pool_k, at, cache.k[:, 0, start:start + bs])
        _pool_set(self._pool_v, at, cache.v[:, 0, start:start + bs])
        return logits[0]

    def _run_chunk(self, slot: int, seq, total: int, start: int):
        """The chunk of ``seq`` at [start, start + block) for ``slot``
        (zero-padded past ``total``), through _chunk_prefill at the
        power-of-two gather width."""
        bs = self.block_size
        chunk = np.zeros((bs,), np.int64)
        avail = min(bs, total - start)
        chunk[:avail] = seq[start:start + avail]
        n_b = self._gather_bucket(self._blocks_for(start + bs))
        return self._chunk_prefill(
            n_b, self._tensor(self._table[slot, :n_b], torch.long),
            self._tensor(chunk), start, int(self._table[slot, start // bs]),
        )

    def _prefill_tail_chunks(self, slot: int, seq, total: int, start: int):
        """Synchronous block-chunked prefill of positions [start, total)
        for an automatic prefix-cache hit, through the chunk-prefill
        program. Returns the last chunk's logits and the position of its
        first row."""
        pos = start
        while pos < total:
            logits = self._run_chunk(slot, seq, total, pos)
            pos += self.block_size
        return logits, pos - self.block_size

    def _pump_prefill(self) -> Dict[int, int]:
        """Advance the OLDEST pending admission by one chunk; on its final
        chunk, sample the first token and activate the row. Returns
        {rid: first_token} when a row activates, else {}."""
        rid = self._pending[0]
        st = self._pending_state[rid]
        slot, seq, total = st["slot"], st["seq"], st["total"]
        start = st["next_pos"]
        obs, ouid = self._observatory, self._obs_uid.get(rid)
        if obs is not None and ouid is not None and start == st["start0"]:
            # first chunk: queued ends, prefill begins (and spans the
            # waits between chunks until activation)
            obs.prefill_start(ouid)
        logits = self._run_chunk(slot, seq, total, start)
        st["next_pos"] = start + self.block_size
        if st["next_pos"] < total:
            return {}
        # final chunk: sample from the last REAL prompt position
        self._pending.pop(0)
        self._pending_state.pop(rid)
        first = self._sample_one(logits[(total - 1) - start][None], st["tkp"])
        self.prefilled_tokens_total += total - st["start0"]
        self.admitted_tokens_total += total
        if self._prefix_cache is not None:
            self._prefix_cache.insert(seq[:total], self._table[slot])
        self._activate(rid, slot, seq, total, first)
        if self.shared_pool is not None:
            self._seq_tokens[rid] = np.asarray(seq[:total], np.int32).copy()
        if obs is not None and ouid is not None:
            self._obs_prefill_done(ouid, slot, total - st["start0"])
        if first in self._stop[rid]:
            self._finish(rid, "stop_token")
        elif self.role == "prefill":
            self._finish(rid, "prefilled")
        return {rid: first}

    def _obs_prefill_done(self, ouid: int, slot: int, computed: int) -> None:
        """The prefill's attribution; a non-prefill role's first token
        (a prefill-role first token is a publication artifact: the
        stitched record's decode side stamps the client's TTFT)."""
        blocks = int(np.count_nonzero(self._table[slot]))
        self._observatory.prefill_done(
            ouid, computed_tokens=computed, kv_blocks=blocks,
            kv_bytes=blocks * self.kv_block_bytes,
        )
        if self.role != "prefill":
            self._observatory.first_token(ouid)

    def _activate(self, rid: int, slot: int, seq, total: int, first: int,
                  draft_width: Optional[int] = None) -> None:
        """Seat an admitted request in its slot; a speculative engine first
        prefills the draft's row on ``seq[:total]``."""
        if self.draft_params is not None:
            self._draft_prefill_row(slot, seq, total, draft_width)
        self._lengths[slot] = total
        self._host_len[slot] = total
        self._last[slot] = first
        self._slot_of[rid] = slot
        self._streams[rid] = [first]

    # -- request surface ---------------------------------------------

    @torch.no_grad()
    def register_prefix(self, tokens) -> int:
        """Prefill a shared prefix (a system prompt) once into pool blocks;
        admit()/enqueue() with ``prefix=`` then map its full blocks into
        the request's table under refcounts instead of recomputing or
        copying it. Returns a prefix id."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        plen = len(tokens)
        if plen == 0:
            raise ValueError("empty prefix")
        bucket = next((b for b in self.buckets if b >= plen), None)
        if bucket is None:
            raise ValueError(
                f"prefix length {plen} exceeds largest bucket "
                f"{self.buckets[-1]}"
            )
        need = self._blocks_for(plen)
        block_ids: List[int] = []
        try:
            for bid in self._take_blocks(need):
                block_ids.append(bid)
        except RuntimeError as e:
            # a failed registration frees its partial grab
            for bid in block_ids:
                self._alloc.drop(bid)
            raise ValueError(str(e)) from e
        padded = np.zeros((bucket,), np.int64)
        padded[:plen] = tokens
        phys = np.full((bucket // self.block_size,), _JUNK, np.int64)
        phys[:need] = block_ids
        self._scratch_forward(self._tensor(padded), [], 0, 0, phys)
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = (block_ids, plen, tokens)
        return pid

    def release_prefix(self, pid: int) -> None:
        """Drop the prefix's hold on its pool blocks. Requests admitted
        with it keep their refcounted shares; the blocks free when the
        last sharer releases."""
        block_ids, _, _ = self._prefixes.pop(pid)
        for bid in block_ids:
            self._alloc.drop(bid)

    def _claim_admission(self, prompt, prefix, temperature, top_k, top_p,
                         need_bucket: bool, slo: Optional[str] = None):
        """Validate, claim a slot, resolve per-request sampling and map
        blocks (shared full prefix blocks, from a registered prefix or the
        longest cached chain, plus private ones), rolling back on failure.
        A draining lifecycle watcher refuses every admission. Returns the
        claim as a dict."""
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
        # int32, as the JAX engine holds tokens: the chain digests hash
        # these bytes
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = len(prompt)
        if p == 0:
            raise ValueError("empty prompt")
        bs = self.block_size
        pref_blocks, plen, pref_padded = [], 0, 0
        pref_tokens = np.zeros((0,), np.int32)
        auto_hit = False
        if prefix is not None:
            if prefix not in self._prefixes:
                raise ValueError(f"unknown or released prefix {prefix}")
            pref_blocks, plen, pref_tokens = self._prefixes[prefix]
            pref_padded = self._blocks_for(plen) * bs
        elif self._prefix_cache is not None:
            # the longest cached block chain becomes an internal prefix;
            # at least one prompt token is left to prefill (its logits
            # give the first token). Hits count only once the claim holds.
            blocks, covered = self._prefix_cache.lookup(
                prompt[: ((p - 1) // bs) * bs]
            )
            if covered:
                auto_hit = True
                pref_blocks, plen, pref_padded = blocks, covered, covered
                pref_tokens = prompt[:covered]
                prompt = prompt[covered:]
                p = len(prompt)
        bucket = None
        if need_bucket:
            bucket = next((b for b in self.buckets if b >= p), None)
            if bucket is None:
                raise ValueError(
                    f"prompt length {p} exceeds largest bucket "
                    f"{self.buckets[-1]}"
                )
        total = plen + p
        if total >= self.max_len:
            raise ValueError(
                f"prefix+prompt length {total} leaves no room to decode "
                f"(max_len {self.max_len})"
            )
        if (need_bucket and not auto_hit
                and pref_padded + bucket > self.max_len):
            # the explicit-prefix scratch cache is (pref_padded + bucket)
            # wide; cache-hit tails prefill chunked instead
            raise ValueError(
                "prefix bucket + prompt bucket exceed the slot row")
        if not self._free:
            raise ValueError("no free slot; release() one first")
        slot = self._free.pop(0)
        d_temp, d_topk, d_topp = self._sampling
        temp = d_temp if temperature is None else float(temperature)
        tk = d_topk if top_k is None else int(top_k)
        tp = d_topp if top_p is None else float(top_p)
        if self.draft_params is not None and (tk or tp):
            self._free.insert(0, slot)
            raise ValueError(
                "speculative serving supports greedy/temperature sampling "
                "only (no top-k/top-p)"
            )
        self._row_temp[slot] = temp
        self._row_topk[slot] = tk
        self._row_topp[slot] = tp
        # share FULL prefix blocks only, allocate the rest (incl. the next
        # decode write's block)
        n_shared = plen // bs
        try:
            for j in range(n_shared):
                self._table[slot, j] = self._alloc.share(pref_blocks[j])
            self._ensure_blocks(slot, total + 1)
        except RuntimeError as e:
            self._drop_row(slot)
            self._free_slot(slot)
            raise ValueError(str(e)) from e
        if self._prefix_cache is not None and prefix is None:
            # the claim held: this admission counts against the cache
            self._prefix_cache.record_admission(plen if auto_hit else 0)
            if auto_hit:
                self.adoptions_total += 1
                self.adopted_tokens_total += plen
                if self.shared_pool is not None:
                    self.shared_pool.adoptions += 1
                    self.shared_pool.adopted_tokens += plen
        seq = np.concatenate([pref_tokens, prompt]).astype(np.int32)
        # the observatory's partition opens here; a decode-role cache hit
        # over a shared pool first adopts the record the prefill role
        # published under the covered chain, continuing its partition
        ouid = None
        obs = self._observatory
        if obs is not None:
            digests = chain_hashes(seq, bs)
            adopted = None
            if auto_hit and self.shared_pool is not None and n_shared:
                adopted = self.shared_pool.adopt_request(digests[n_shared - 1])
            if adopted is not None:
                ouid = obs.adopt(adopted, engine_key=id(self))
            else:
                ouid = obs.admit(id(self), slo=slo)
            obs.prefill_done(
                ouid, cached_tokens=plen,
                prefix_digest=digests[-1].hex() if digests else "",
                chain_digests=tuple(digests),
            )
        return dict(
            prompt=prompt, p=p, bucket=bucket, seq=seq,
            pref_blocks=pref_blocks, plen=plen, pref_padded=pref_padded,
            total=total, slot=slot, n_shared=n_shared,
            tkp=(temp, tk, tp), auto_hit=auto_hit, ouid=ouid,
        )

    @torch.no_grad()
    def admit(
        self,
        prompt,
        prefix: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_tokens: Sequence[int] = (),
        slo: Optional[str] = None,
    ) -> int:
        """Prefill a prompt (1-D int sequence) into a free slot; returns
        the request id. The first generated token is already in
        stream(rid). With ``prefix=`` (a register_prefix id) the sequence
        is prefix + prompt and only the prompt's forward runs. The
        arguments are the JAX engine's, in its order. temperature/top_k/
        top_p override the engine-wide defaults for this request;
        emitting any of ``stop_tokens`` auto-finishes it (the stop token
        is part of the stream). ``slo`` ("ttft" | "tpot" | "batch",
        default batch) is an accounting annotation; it never changes
        scheduling.

        Writes a ``serving.admit`` span (counter ``live_rows``, the rows
        live before it) around the phases ``.claim``, ``.forward`` (the
        prefill's launches; counter ``self_attn_kernel``, 1 where the
        flash kernel launched in it), ``.sample`` (the first token's
        read, where the host waits for the card) and ``.finish``; a
        refused admission leaves it open, so the log drops it."""
        live_rows = len(self._slot_of)
        outer = SPANS.open("serving.admit")
        sp = SPANS.open("serving.admit.claim")
        c = self._claim_admission(
            prompt, prefix, temperature, top_k, top_p, need_bucket=True,
            slo=slo,
        )
        SPANS.close(sp)
        sp = SPANS.open("serving.admit.forward")
        p, bucket, plen, total = c["p"], c["bucket"], c["plen"], c["total"]
        slot, n_shared, seq, tkp = c["slot"], c["n_shared"], c["seq"], c["tkp"]
        bs = self.block_size
        nb_req = self._blocks_for(total + 1)
        # a synchronous prefill stalls every live decode on this engine:
        # the observatory attributes that time to their ``stalled`` phase
        obs, ouid = self._observatory, c["ouid"]
        if obs is not None and ouid is not None:
            obs.prefill_start(ouid)
            obs.stall_begin(id(self))
        flash_before = FLASH_FWD.launches
        if c["auto_hit"]:
            # cache hit: the tail prefills chunked, block by block
            logits, at = self._prefill_tail_chunks(
                slot, seq, total, n_shared * bs)
            first_row = (total - 1) - at
        else:
            padded = np.zeros((bucket,), np.int64)
            padded[:p] = c["prompt"]
            # scatter map over the scratch's logical blocks: shared
            # prefix blocks are not written back (junk), the partial
            # prefix tail and the prompt land in private blocks, bucket
            # padding past the request's need goes to junk
            pref_padded = c["pref_padded"]
            nb_mini = (pref_padded + bucket) // bs
            phys = np.full((nb_mini,), _JUNK, np.int64)
            for j in range(n_shared, min(nb_req, nb_mini)):
                phys[j] = self._table[slot, j]
            logits = self._scratch_forward(
                self._tensor(padded), c["pref_blocks"], pref_padded, plen,
                phys)[0]
            first_row = p - 1
        SPANS.close(sp, (
            ("self_attn_kernel", int(FLASH_FWD.launches > flash_before)),))
        sp = SPANS.open("serving.admit.sample")
        first = self._sample_one(logits[first_row][None], tkp)
        SPANS.close(sp)
        sp = SPANS.open("serving.admit.finish")
        self.prefilled_tokens_total += p
        self.admitted_tokens_total += total
        if self._prefix_cache is not None:
            # publish the full blocks of the real sequence (cached ones
            # dedupe by digest), explicit-prefix admissions included
            self._prefix_cache.insert(seq, self._table[slot])
        if obs is not None and ouid is not None:
            obs.stall_end(id(self))
        rid = self._next_rid
        self._next_rid += 1
        self._stop[rid] = frozenset(int(t) for t in stop_tokens)
        # the draft row's width: an explicit prefix takes the target's
        # (padded prefix + bucket) scratch width, a cache hit the default
        # power-of-two rounding
        self._activate(
            rid, slot, seq, total, first,
            draft_width=None if c["auto_hit"] else c["pref_padded"] + bucket,
        )
        if self.shared_pool is not None:
            self._seq_tokens[rid] = seq
        if obs is not None and ouid is not None:
            self._obs_uid[rid] = ouid
            self._obs_prefill_done(ouid, slot, p)
        if first in self._stop[rid]:
            self._finish(rid, "stop_token")
        elif self.role == "prefill":
            # publish-and-release: the cached blocks are the output; the
            # first token stays readable through release()
            self._finish(rid, "prefilled")
        SPANS.close(sp)
        t1 = SPANS.close(outer, (("live_rows", live_rows),))
        if self._recorder is not None:
            rec = dict(
                rid=rid, prompt_len=p, prefix_len=plen, bucket=bucket,
                duration_ms=round((t1 - SPANS.t0_ns(outer)) / 1e6, 3),
                used_blocks=self.used_blocks, slo=normalize_slo(slo),
            )
            if ouid is not None:
                rec["request_uid"] = ouid
            if c["auto_hit"]:
                rec["cached_tokens"] = plen
            if self._prefix_cache is not None:
                rec["prefix_cache_hit"] = bool(c["auto_hit"])
            self._recorder.record("serving_admit", **rec)
        return rid

    def enqueue(
        self,
        prompt,
        prefix: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop_tokens: Sequence[int] = (),
        slo: Optional[str] = None,
    ) -> int:
        """CHUNKED admission: claim a slot and blocks now, run the prefill
        one block-sized chunk per step() from the first non-shared block
        boundary (an unaligned prefix tail is recomputed into the private
        block). The request's first token appears in the step() result
        that activates it. A pending rid can be cancelled with release()
        (returns [])."""
        c = self._claim_admission(
            prompt, prefix, temperature, top_k, top_p, need_bucket=False,
            slo=slo,
        )
        rid = self._next_rid
        self._next_rid += 1
        if c["ouid"] is not None:
            self._obs_uid[rid] = c["ouid"]
        self._stop[rid] = frozenset(int(t) for t in stop_tokens)
        self._pending.append(rid)
        start = c["n_shared"] * self.block_size
        self._pending_state[rid] = dict(
            slot=c["slot"], seq=c["seq"], total=c["total"], next_pos=start,
            start0=start, tkp=c["tkp"],
        )
        return rid

    @torch.no_grad()
    def step(self) -> Dict[int, object]:
        """Advance every live request; returns {rid: token}, or with a
        draft model {rid: [tokens...]} (each row's accepted drafts and
        correction: one or more tokens). One pending chunked prefill
        advances first; a row it activates sits this decode out and
        reports its first token instead. Rows that fill to max_len, emit a
        stop token or starve for pool blocks auto-finish
        (``finish_reason`` says which).

        Writes a ``serving.step`` span (counter ``live_rows``, at its
        start) around the phases ``.prefill_chunk`` (when a chunked
        admission is pending), ``.prepare`` (block tables and their copies
        to the device), ``.forward`` (the decode's launches), ``.sync``
        (the tokens' read, where the host waits for the card) and
        ``.bookkeep``."""
        outer = SPANS.open("serving.step")
        live_rows = len(self._slot_of)
        obs = self._observatory
        ot0 = obs.clock.monotonic() if obs is not None else 0.0
        ev0 = self._evictions_total
        activated = {}
        if self._pending:
            sp = SPANS.open("serving.step.prefill_chunk")
            activated = self._pump_prefill()
            SPANS.close(sp)
        ot1 = obs.clock.monotonic() if obs is not None else 0.0
        self._settling = {
            self._slot_of[r] for r in activated if r in self._slot_of
        }
        try:
            if self.draft_params is not None:
                out = {**{r: [t] for r, t in activated.items()},
                       **self._step_speculative()}
            else:
                out = {**activated, **self._step_plain()}
        finally:
            self._settling = set()
        emitted = sum(
            len(v) if isinstance(v, list) else 1 for v in out.values())
        if obs is not None:
            obs.step(
                id(self), live=len(self._slot_of), slots=self.slots,
                pending=len(self._pending), activated=len(activated),
                evicted=self._evictions_total - ev0,
                emitted_tokens=emitted, prefill_s=ot1 - ot0,
                decode_s=obs.clock.monotonic() - ot1,
            )
        t1 = SPANS.close(outer, (("live_rows", live_rows),))
        if self._recorder is not None:
            self._recorder.record(
                "serving_step",
                duration_ms=round((t1 - SPANS.t0_ns(outer)) / 1e6, 3),
                emitted_tokens=emitted,
                live_requests=len(self._slot_of),
                pending_prefills=len(self._pending),
                used_blocks=self.used_blocks,
                pool_blocks=self.pool_blocks,
            )
        return out

    def _back_live_rows(self, width: int):
        """Back the next ``width`` write positions of every live row (not
        one settling this step) with pool blocks; a row that cannot get
        them finishes as pool_exhausted (freeing its blocks may unblock
        later rows). Returns (live slots, write blocks and offsets [slots,
        width], junk for frozen rows, and the gather width in blocks), or
        None when no row is left."""
        rid_of_slot = {
            s: r for r, s in self._slot_of.items() if s not in self._settling
        }
        for s in sorted(rid_of_slot):
            try:
                self._ensure_blocks(s, int(self._host_len[s]) + width)
            except RuntimeError:
                self._finish(rid_of_slot[s], "pool_exhausted")
        live_slots = set(self._slot_of.values()) - self._settling
        if not live_slots:
            return None
        bs = self.block_size
        wblk = np.full((self.slots, width), _JUNK, np.int64)
        woff = np.zeros((self.slots, width), np.int64)
        for s in live_slots:
            w = int(self._host_len[s]) + np.arange(width)
            wblk[s] = self._table[s, w // bs]
            woff[s] = w % bs
        n_b = self._gather_bucket(max(
            self._blocks_for(int(self._host_len[s]) + width)
            for s in live_slots))
        return live_slots, wblk, woff, n_b

    def _step_plain(self) -> Dict[int, int]:
        if not self._slot_of:
            return {}
        sp = SPANS.open("serving.step.prepare")
        backed = self._back_live_rows(1)
        if backed is None:
            SPANS.close(sp)
            return {}
        live_slots, wblk, woff, n_b = backed
        live = sorted(live_slots)
        table_b = self._tensor(self._table[:, :n_b], torch.int32)
        active = self._tensor([s in live_slots for s in range(self.slots)])
        greedy = not (self._row_temp[live] > 0.0).any()
        step = self._step_kernel if self.paged_kernel else self._step_gather
        args = (
            table_b, active, greedy, self._tensor(self._row_temp),
            self._tensor(self._row_topk), self._tensor(self._row_topp),
            self._tensor(wblk[:, 0]), self._tensor(woff[:, 0]),
        )
        SPANS.close(sp)
        sp = SPANS.open("serving.step.forward")
        nxt = step(*args)
        # frozen slots keep their token and length
        self._last = torch.where(active, nxt, self._last)
        self._lengths = torch.where(active, self._lengths + 1, self._lengths)
        self._host_len[live] += 1
        self.decode_steps_total += 1
        SPANS.close(sp)
        sp = SPANS.open("serving.step.sync")
        toks = self._last.cpu().numpy()
        SPANS.close(sp)
        sp = SPANS.open("serving.step.bookkeep")
        out = {}
        for rid, slot in list(self._slot_of.items()):
            if slot in self._settling:
                continue
            tok = int(toks[slot])
            self._streams[rid].append(tok)
            out[rid] = tok
            ouid = self._obs_uid.get(rid)
            if ouid is not None:
                self._observatory.tokens_emitted(ouid, 1)
            # a row at max_len-1 can't take another write
            if int(self._host_len[slot]) >= self.max_len - 1:
                self._finish(rid, "max_len")
            elif tok in self._stop[rid]:
                self._finish(rid, "stop_token")
        SPANS.close(sp)
        return out

    # -- speculative mode --------------------------------------------

    def _draft_prefill_row(self, slot: int, seq, total: int,
                           width: Optional[int] = None) -> None:
        """Prefill the draft's dense row for positions [0, total) of
        ``seq``: a full recompute in one chunk of ``width`` (the draft is
        cheap by design). The default width rounds through the
        power-of-two block buckets, as the JAX engine's compiled widths."""
        if width is None:
            width = (self._gather_bucket(self._blocks_for(total))
                     * self.block_size)
        run = np.zeros((width,), np.int64)
        run[:total] = seq[:total]
        mini = KVCache.empty(self.draft_cfg, 1, width, device=self.device)
        _, mini = _forward_chunk(
            self.draft_params, self._tensor(run)[None], mini, self.draft_cfg)
        self._draft_k[:, slot, :width] = mini.k[:, 0]
        self._draft_v[:, slot, :width] = mini.v[:, 0]

    def _draft_catchup(self) -> None:
        """Feed ``last`` through the draft at every row's length: before a
        plain fallback step, so that the draft's cache keeps holding every
        committed token but ``last``, as the target's does."""
        _forward_chunk(
            self.draft_params, self._last[:, None],
            KVCache(k=self._draft_k, v=self._draft_v), self.draft_cfg,
            moe_drop_free=True, positions=self._lengths,
        )

    def _spec_forward(self, table_b, active, temp, wblk, woff):
        """The speculative step over ALL slots in lockstep: the draft
        proposes gamma tokens per row, ONE target verify chunk of width
        gamma + 1 runs at per-row positions over the gathered view, all
        gamma + 1 written positions scatter back to the pool (rejected
        tails stay stale but masked), then per-row accept/resample.
        Frozen rows keep their token and length. Returns (committed
        [slots, gamma + 1], n_emit [slots]) on the device."""
        cfg, dcfg, gamma = self.cfg, self.draft_cfg, self.gamma
        vocab, dev, slots = cfg.vocab, self.device, self.slots
        lengths, toks = self._lengths, self._last
        # every slot's uniforms on every spec step, whatever the rows'
        # temperatures: a request's draws never depend on its neighbours
        u_draft = torch.rand((gamma, slots, vocab), generator=self._gen,
                             device=dev)
        u_accept = torch.rand((slots, gamma), generator=self._gen,
                              device=dev)
        u_correction = torch.rand((slots, vocab), generator=self._gen,
                                  device=dev)
        # -- the draft proposes gamma tokens per row -------------------
        dcache = KVCache(k=self._draft_k, v=self._draft_v)
        tok, draft_toks, draft_q = toks, [], []
        for i in range(gamma):
            logits, _ = _forward_chunk(
                self.draft_params, tok[:, None], dcache, dcfg,
                moe_drop_free=True, positions=lengths + i,
            )
            q = probs_rowwise(logits[:, 0], temp, vocab)
            tok = sample_from_probs(q, uniforms=u_draft[i])
            draft_toks.append(tok)
            draft_q.append(q)
        # cache d_gamma too: a fully accepted round needs its entry next
        # round (stale but masked on a partial accept)
        _forward_chunk(
            self.draft_params, tok[:, None], dcache, dcfg,
            moe_drop_free=True, positions=lengths + gamma,
        )
        draft_toks = torch.stack(draft_toks, dim=1)     # [slots, gamma]
        draft_q = torch.stack(draft_q, dim=1)           # [slots, gamma, V]
        # -- the target verifies every row's gamma + 1 positions at once
        kg, vg = self._gathered_view(table_b)
        chunk = torch.cat([toks[:, None], draft_toks], dim=1)
        tlogits, tcache = _forward_chunk(
            self.params, chunk, KVCache(k=kg, v=vg), cfg,
            moe_drop_free=True, positions=lengths,
        )
        target_p = probs_rowwise(tlogits, temp[:, None], vocab)
        # scatter ALL gamma + 1 written positions back to the pool; clip:
        # a frozen slot's stale length can exceed the gathered width
        idx = (lengths.long()[:, None]
               + torch.arange(gamma + 1, device=dev)).clamp(
                   max=kg.shape[2] - 1)
        rows = torch.arange(slots, device=dev)[:, None]
        at = (slice(None), wblk, woff)
        _pool_set(self._pool_k, at, tcache.k[:, rows, idx])
        _pool_set(self._pool_v, at, tcache.v[:, rows, idx])
        # -- per-row accept / resample, then commit ----------------------
        n_acc, correction = accept_resample(
            target_p, draft_q, draft_toks, u_accept, u_correction)
        # committed: draft_toks[:n_acc] then the correction; positions at
        # and past n_acc carry the correction (the host slices by n_emit)
        committed = torch.where(
            torch.arange(gamma + 1, device=dev)[None] < n_acc[:, None],
            torch.cat([draft_toks, correction[:, None]], dim=1),
            correction[:, None],
        )
        n_emit = torch.where(active, n_acc + 1, 0)
        self._lengths = (lengths + n_emit).to(torch.int32)
        self._last = torch.where(active, correction, toks)
        return committed, n_emit

    def _step_speculative(self) -> Dict[int, List[int]]:
        if not self._slot_of:
            return {}
        g = self.gamma
        # a row within gamma of max_len cannot take a full verify chunk:
        # catch the draft up and take a plain step (the row finishes at
        # max_len within a few of these)
        if any(int(self._host_len[s]) + g >= self.max_len
               for s in self._slot_of.values() if s not in self._settling):
            sp = SPANS.open("serving.step.forward")
            self._draft_catchup()
            SPANS.close(sp)
            return {rid: [tok] for rid, tok in self._step_plain().items()}
        # back the whole verify chunk (positions len..len+gamma) per slot
        sp = SPANS.open("serving.step.prepare")
        backed = self._back_live_rows(g + 1)
        if backed is None:
            SPANS.close(sp)
            return {}
        live_slots, wblk, woff, n_b = backed
        args = (
            self._tensor(self._table[:, :n_b], torch.int32),
            self._tensor([s in live_slots for s in range(self.slots)]),
            self._tensor(self._row_temp), self._tensor(wblk),
            self._tensor(woff),
        )
        SPANS.close(sp)
        sp = SPANS.open("serving.step.forward")
        committed, n_emit = self._spec_forward(*args)
        SPANS.close(sp)
        sp = SPANS.open("serving.step.sync")
        committed, n_emit = committed.cpu().numpy(), n_emit.cpu().numpy()
        SPANS.close(sp)
        sp = SPANS.open("serving.step.bookkeep")
        # per-row economics: gamma proposed, n_emit - 1 survived
        rows = [s for s in self._slot_of.values() if s not in self._settling]
        rounds, drafted, accepted = self.spec_stats
        self.spec_stats = SpecStats(
            rounds=rounds + 1, drafted=drafted + g * len(rows),
            accepted=accepted + sum(int(n_emit[s]) - 1 for s in rows))
        out: Dict[int, List[int]] = {}
        for rid, slot in list(self._slot_of.items()):
            if slot in self._settling:
                continue
            toks = committed[slot][: int(n_emit[slot])].tolist()
            self._host_len[slot] += int(n_emit[slot])
            # the stream ends AT its first stop token; later tokens of the
            # same round are dropped
            cut = next(
                (i for i, t in enumerate(toks) if t in self._stop[rid]), None)
            if cut is not None:
                toks = toks[: cut + 1]
            self._streams[rid].extend(toks)
            out[rid] = toks
            if cut is not None:
                self._finish(rid, "stop_token")
            elif int(self._host_len[slot]) >= self.max_len - 1:
                self._finish(rid, "max_len")
        SPANS.close(sp)
        return out

    def _finish(self, rid: int, reason: str = "released") -> None:
        slot = self._slot_of.pop(rid)
        self.finish_reason[rid] = reason
        if reason == "pool_exhausted":
            self._evictions_total += 1
        obs = self._observatory
        ouid = self._obs_uid.pop(rid, None)
        if obs is not None and ouid is not None:
            # block count before _drop_row zeroes the row
            blocks = int(np.count_nonzero(self._table[slot]))
            published = False
            if reason == "prefilled" and self.shared_pool is not None:
                # disaggregated handoff: the partition stays open until a
                # decode engine adopts the record off the pool's registry
                rec = obs.handoff_begin(ouid)
                if rec is not None and rec.chain_digests:
                    self.shared_pool.publish_request(rec.chain_digests, rec)
                    published = True
            if not published:
                obs.finish(
                    ouid, reason, kv_blocks=blocks,
                    kv_bytes=blocks * self.kv_block_bytes,
                )
        self._drop_row(slot)
        self._free_slot(slot)
        self._seq_tokens.pop(rid, None)

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
            ouid = self._obs_uid.pop(rid, None)
            if self._observatory is not None and ouid is not None:
                self._observatory.finish(ouid, "cancelled")
            self._drop_row(st["slot"])
            self._free_slot(st["slot"])
            self._stop.pop(rid, None)
            self._seq_tokens.pop(rid, None)
            return []
        if rid in self._slot_of:
            self._finish(rid)
        self._stop.pop(rid, None)
        self.finish_reason.pop(rid, None)
        return self._streams.pop(rid)

    # -- mid-stream handoff (live migration) -------------------------
    #
    # Hand an OPEN stream (KV blocks, generation cursor, sampling and stop
    # state, emitted tokens) from a draining engine to a peer on the same
    # SharedKVPool mid-decode: blocks move by refcount, never by copy, so
    # positions [0, host_len) stay the bytes the source wrote and a greedy
    # adopted stream equals the one the source would have produced.

    def publish_stream(self, rid: int) -> dict:
        """Publish a LIVE request's decode state through the shared pool's
        stream registry and release its slot here. The record holds the
        slot's block chain (one registry-owned refcount per block), the
        cursor, the real token history, the emitted stream, sampling and
        stop state and the open observatory partition. The rid finishes
        as ``handoff``; its stream stays readable."""
        if self.shared_pool is None:
            raise ValueError(
                "publish_stream needs a SharedKVPool (the registry is the "
                "transport; solo engines have no peer to adopt)"
            )
        if rid in self._pending_state:
            raise ValueError(
                f"request {rid} is still prefilling; pump step() until it "
                "activates (or release() to cancel) before handoff"
            )
        if rid not in self._slot_of:
            raise ValueError(f"request {rid} is not live")
        slot = self._slot_of[rid]
        hl = int(self._host_len[slot])
        full = np.concatenate([
            self._seq_tokens[rid], np.asarray(self._streams[rid], np.int32),
        ]).astype(np.int32)
        # KV positions [0, hl) back full[:hl]; the newest stream token's
        # K/V is written on its feed-back step, so it travels as ``last``
        blocks = [int(self._table[slot, j])
                  for j in range(self._blocks_for(hl))]
        for bid in blocks:
            self._alloc.share(bid)
        obs_rec = None
        ouid = self._obs_uid.get(rid)
        if self._observatory is not None and ouid is not None:
            obs_rec = self._observatory.handoff_begin(ouid)
        record = {
            "kind": "stream",
            "blocks": blocks,
            "host_len": hl,
            "tokens": full,
            "stream": list(self._streams[rid]),
            "last": int(full[hl]) if hl < len(full) else int(full[-1]),
            "temp": float(self._row_temp[slot]),
            "topk": int(self._row_topk[slot]),
            "topp": float(self._row_topp[slot]),
            "stop": tuple(int(t) for t in self._stop.get(rid, ())),
            "digests": tuple(chain_hashes(full[:hl], self.block_size)),
            "obs": obs_rec,
        }
        self.shared_pool.publish_stream(record)
        self.stream_handoffs_out += 1
        # the partition continues at the adopter: drop the uid first so
        # that _finish does not close it
        self._obs_uid.pop(rid, None)
        self._finish(rid, "handoff")
        return record

    def adopt_stream(self, record: Optional[dict] = None) -> Optional[int]:
        """Adopt a mid-stream handoff from the shared pool (the oldest
        pending record, or one the caller claimed): seat it in a free
        slot, inherit the record's block refcounts (no copy), restore
        cursor, sampling, stop and stream state, and continue decoding.
        Returns the new rid, or None when nothing is pending. On a seating
        failure (no slot, pool dry for the write block) the record goes
        back to the registry's front and ValueError raises."""
        if self.shared_pool is None:
            raise ValueError("adopt_stream needs a SharedKVPool")
        if record is None:
            record = self.shared_pool.claim_stream()
            if record is None:
                return None
        if not self._free:
            self.shared_pool.restore_stream(record)
            raise ValueError("no free slot; release() one first")
        slot = self._free.pop(0)
        hl = int(record["host_len"])
        blocks = record["blocks"]
        for j, bid in enumerate(blocks):
            self._table[slot, j] = bid  # the registry's refcount, inherited
        try:
            # the next decode write's block may be fresh (hl on a block
            # boundary): allocate it privately
            self._ensure_blocks(slot, hl + 1)
        except RuntimeError as e:
            # roll back without _drop_row: the inherited refs belong to
            # the record, which goes back to the registry intact
            for j in range(len(blocks), self.max_blocks):
                bid = int(self._table[slot, j])
                if bid != _JUNK:
                    self._alloc.drop(bid)
            self._table[slot, :] = _JUNK
            self._free_slot(slot)
            self.shared_pool.restore_stream(record)
            raise ValueError(str(e)) from e
        rid = self._next_rid
        self._next_rid += 1
        self._slot_of[rid] = slot
        self._streams[rid] = list(record["stream"])
        self._stop[rid] = frozenset(record["stop"])
        self._row_temp[slot] = record["temp"]
        self._row_topk[slot] = record["topk"]
        self._row_topp[slot] = record["topp"]
        self._lengths[slot] = hl
        self._host_len[slot] = hl
        self._last[slot] = int(record["last"])
        tokens = np.asarray(record["tokens"], np.int32)
        self._seq_tokens[rid] = tokens[
            : len(tokens) - len(record["stream"])
        ].copy()
        self.stream_handoffs_in += 1
        obs_rec = record.get("obs")
        if self._observatory is not None and obs_rec is not None:
            self._obs_uid[rid] = self._observatory.adopt(
                obs_rec, engine_key=id(self)
            )
        return rid
