"""Autoregressive generation with a KV cache, PyTorch port.

Counterpart of ``elastic_tpu_agent/workloads/generate.py``: the same
``KVCache`` layout ([n_layers, b, max_len, kv_heads, h]), the same chunk
forward (plain and per-row ``positions=`` modes), the same sampling
algebra. Where JAX returns an updated cache from a pure function, the port
writes the cache tensors in place and returns them; the decode loop is a
Python loop (PyTorch runs eagerly, so there is no scan to compile).

The cached attention is materialised-scores ``einsum`` over the cache, as
in the JAX package (no Pallas kernel there either), with one exception: a
chunk that starts at position 0 on a CUDA bf16 cache attends only to its
own keys, so it runs the flash forward kernel on its own q, k and v
(``_chunk_self_attends``). MoE layers take the
JAX capacity policy: a prefill chunk routes with the training capacity
factor, drops included; a decode step is drop-free. The chunk forward's
``ring=`` mode writes one token into a ring-buffer cache for streaming
decode (``streaming.py``).

``generate(..., mesh=)`` is JAX's sharded decode, run SPMD
(``parallel.py``'s process model): with ``decode_shardings``' split specs
each rank holds its tp heads (and FF hidden, vocabulary) of the params and
decodes its dp rows of the batch into a cache of its kv heads
``[L, b/dp, max_len, g/tp, h]``. ``copy_to``/``reduce_from`` sit around
the projections as in the train step's forward; the vocab-split logits
are all-gathered over tp before sampling (greedy ties break on the global
first index), and the dp rows are all-gathered at the end, so every rank
returns the whole ``[b, p + new]``. A sampled decode draws the uniforms of
the whole batch from the one generator and takes its rows, so its stream
is the single-device one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from .attention import NEG_INF, FlashConfig, flash_attention, supports_flash
from .moe import moe_mlp
from .parallel import (
    LocalView,
    _gather_axis,
    _spec_at,
    axis_size,
    copy_to,
    full_param_shardings,
    local_view,
    reduce_from,
    scale_spec,
)
from .quantize import _tree_map, embed_lookup, is_quantized, wdense
from .transformer import (
    ModelConfig,
    _check_device,
    _mlp,
    _rmsnorm,
    as_device,
    rope,
)


@dataclasses.dataclass
class KVCache:
    """Per-layer stacked caches: k, v [n_layers, b, max_len, kv_heads, h],
    plus the current filled length."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @classmethod
    def empty(
        cls, cfg: ModelConfig, batch: int, max_len: int, dtype=None,
        device="cuda",
    ) -> "KVCache":
        shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
        dtype = dtype or cfg.dtype
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
        )


def _qkv(x: torch.Tensor, layer: Dict, cfg: ModelConfig):
    """Projections for a chunk x [b, t, d] -> q [b,t,n,h], k/v [b,t,g,h]."""
    if "wq" in layer:  # GQA
        q = torch.einsum("btd,dnh->btnh", x, wdense(layer, "wq", cfg.dtype))
        kv = torch.einsum(
            "btd,dcgh->bctgh", x, wdense(layer, "wkv", cfg.dtype)
        )
        return q, kv[:, 0], kv[:, 1]
    qkv = torch.einsum(
        "btd,dcnh->bctnh", x, wdense(layer, "wqkv", cfg.dtype)
    )
    return qkv[:, 0], qkv[:, 1], qkv[:, 2]


def _cached_attention(
    q: torch.Tensor,            # [b, t, n, h] for the current chunk
    cache_k: torch.Tensor,      # [b, max_len, g, h] incl. the chunk's keys
    cache_v: torch.Tensor,
    q_pos: Union[int, torch.Tensor],  # position of q[:, 0]: int, or [b]
    cfg: ModelConfig,
    key_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention of the chunk against the masked full cache, at
    kv_heads width: q is viewed as [b, t, g, r, h] (contiguous groups).

    key_positions ([cache_len]) gives each cache slot's ABSOLUTE position
    where slots are not position-ordered (the streaming ring buffer);
    unwritten slots carry a sentinel past any query, which the causal
    compare masks out. None: slot j holds position j."""
    b, t, n, h = q.shape
    g = cache_k.shape[2]          # kv heads (this rank's under a mesh)
    r = n // g
    q5 = q.reshape(b, t, g, r, h)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("btgrh,bsgh->bgrts", q5, cache_k).float() * scale
    max_len = cache_k.shape[1]
    q_pos = torch.as_tensor(q_pos, device=q.device)
    rows = q_pos[..., None, None] + torch.arange(t, device=q.device)[:, None]
    cols = (
        torch.arange(max_len, device=q.device) if key_positions is None
        else key_positions
    )
    keep = cols <= rows                   # [t, s] or [b, t, s]
    if cfg.window > 0:
        keep &= rows - cols < cfg.window
    if keep.dim() == 2:
        keep = keep[None]
    logits = torch.where(keep[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bgrts,bsgh->btgrh", probs.to(cache_v.dtype), cache_v
    )
    return out.reshape(b, t, n, h)


def _chunk_self_attends(
    t: int, cache: KVCache, q_dtype: torch.dtype, device_type: str,
    head_dim: int, positions: Optional[torch.Tensor] = None,
    ring: Optional[Tuple[int, torch.Tensor]] = None,
) -> bool:
    """Whether a chunk of t tokens runs its attention as causal
    self-attention of the chunk through the flash kernel. From position 0
    with slot j holding position j, every key at a position <= a row's own
    is the chunk's, and every cache slot past the chunk is masked, so this
    equals ``_cached_attention``. Only bf16 CUDA chunks whose cache holds
    q's dtype take the kernel; every other chunk keeps the einsum."""
    return (
        cache.length == 0 and positions is None and ring is None
        and t <= cache.k.shape[2] and cache.k.dtype == q_dtype
        and q_dtype == torch.bfloat16 and device_type == "cuda"
        and supports_flash(t, head_dim)
    )


def _cache_write(
    cache_layer: torch.Tensor,        # [b, max_len, g, h]
    kv: torch.Tensor,                 # [b, t, g, h]
    pos: Union[int, torch.Tensor],    # int, or [b] per-row offsets
) -> None:
    """In-place write of the chunk at ``pos``; like lax.dynamic_update_slice,
    a start that would run past the end is clamped back."""
    max_len, t = cache_layer.shape[1], kv.shape[1]
    if not torch.is_tensor(pos) or pos.dim() == 0:
        start = min(max(int(pos), 0), max_len - t)
        cache_layer[:, start:start + t] = kv
        return
    start = pos.long().clamp(0, max_len - t)
    rows = torch.arange(kv.shape[0], device=kv.device)[:, None]
    cols = start[:, None] + torch.arange(t, device=kv.device)[None]
    cache_layer[rows, cols] = kv


def _learned_positions(params: Dict, posmat: torch.Tensor, dtype):
    """Learned position rows at ``posmat``, clamped to the table as JAX's
    gather clamps: a freed serving slot keeps a stale length that can pass
    the table's end (its row is computed in lockstep and discarded)."""
    table = params["pos_embed"]
    return table.to(dtype)[posmat.clamp(max=table.shape[0] - 1)]


def _forward_chunk(
    params: Dict, tokens: torch.Tensor, cache: KVCache, cfg: ModelConfig,
    moe_drop_free: bool = False,
    positions: Optional[torch.Tensor] = None,
    ring: Optional[Tuple[int, torch.Tensor]] = None,
    view: Optional[LocalView] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run a token chunk [b, t] at positions cache.length..+t; returns
    (logits [b, t, vocab] f32, the cache, written in place).

    view: this rank's place in a decode mesh (``generate(mesh=)``): the
    chunk is its dp rows, params and cache its tp shards, and the logits
    are gathered over tp to the whole vocabulary.

    moe_drop_free selects the MoE capacity policy (a one-token chunk is
    not necessarily a decode step: a batch of one-token prompts is still
    prefill): False = the training capacity factor, the forward's
    semantics, drops included; True = capacity T, no token dropped.

    positions: per-row [b] start offsets (continuous-batching decode,
    each slot at its own depth): writes, RoPE, learned positions and the
    mask go row-wise, and the returned length is UNCHANGED (the caller
    owns per-row lengths).

    ring: (slot, key_positions) for streaming decode over a rolling-window
    cache: the one token's K/V land in ring slot ``slot`` (an int, the
    absolute position modulo the cache length: a write start is clamped,
    so a position past the ring would overwrite a live slot), and
    key_positions [cache_len] maps every slot to its absolute position for
    the mask. RoPE still rotates by the absolute position cache.length.
    Exclusive with positions; the returned length is unchanged (the caller
    tracks the stream position).

    A chunk that ``_chunk_self_attends`` attends through the flash kernel
    on its own rotated k/v (the values the cache gets), without autograd;
    the cache is written all the same."""
    b, t = tokens.shape
    if ring is not None and (positions is not None or t != 1):
        raise ValueError(
            "ring mode decodes one token per call, without positions="
        )
    dev = tokens.device
    pos = cache.length if positions is None else positions
    self_attn = _chunk_self_attends(
        t, cache, cfg.dtype, dev.type, cfg.head_dim, positions, ring
    )
    x = embed_lookup(params, tokens, cfg.dtype)
    if positions is None:
        posmat = pos + torch.arange(t, device=dev)                  # [t]
    else:
        posmat = pos.long()[:, None] + torch.arange(t, device=dev)[None]
    if cfg.pos == "learned":
        pe = _learned_positions(params, posmat, cfg.dtype)
        x = x + (pe[None] if posmat.dim() == 1 else pe)

    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1_scale"])
        if view is not None:
            h = copy_to(h, view.tp)
        q, k_c, v_c = _qkv(h, layer, cfg)
        if cfg.pos == "rope":
            # rotated keys go INTO the cache (absolute rotations)
            q = rope(q, posmat, cfg.rope_theta)
            k_c = rope(k_c, posmat, cfg.rope_theta)
        write_at = pos if ring is None else ring[0]
        k_c, v_c = k_c.to(cache.k.dtype), v_c.to(cache.v.dtype)
        _cache_write(cache.k[i], k_c, write_at)
        _cache_write(cache.v[i], v_c, write_at)
        if self_attn:
            with torch.no_grad():
                attn = flash_attention(
                    q, k_c, v_c, FlashConfig(causal=True, window=cfg.window)
                )
        else:
            attn = _cached_attention(
                q, cache.k[i], cache.v[i], pos, cfg,
                key_positions=None if ring is None else ring[1],
            )
        out = torch.einsum(
            "btnh,nhd->btd", attn, wdense(layer, "wo", cfg.dtype)
        )
        x = x + (out if view is None else reduce_from(out, view.tp))
        h2 = _rmsnorm(x, layer["ln2_scale"])
        x = x + _chunk_mlp(h2, layer, cfg, moe_drop_free, view)
    x = _rmsnorm(x, params["final_norm_scale"])
    if view is not None:
        x = copy_to(x, view.tp)
    logits = torch.einsum(
        "btd,dv->btv", x, wdense(params, "lm_head", cfg.dtype)
    ).float()
    if view is not None:
        logits = _gather_axis(logits, 2, view.tp)
    new_len = (
        cache.length + t if positions is None and ring is None
        else cache.length
    )
    return logits, KVCache(k=cache.k, v=cache.v, length=new_len)


def _chunk_mlp(
    h: torch.Tensor, layer: Dict, cfg: ModelConfig, moe_drop_free: bool,
    view: Optional[LocalView] = None,
) -> torch.Tensor:
    """The layer's MLP on a normed chunk [b, t, d]: dense, or MoE with the
    capacity policy ``moe_drop_free`` picks (factor E: capacity T)."""
    if "moe" not in layer:
        return _mlp(h, layer, cfg, view)
    factor = (
        float(cfg.moe_experts) if moe_drop_free else cfg.moe_capacity_factor
    )
    return moe_mlp(h, layer["moe"], factor, view)[0]


# -- sampling ------------------------------------------------------------
#
# jax.random.categorical(key, logits) is argmax(logits + Gumbel noise);
# the port draws the same form from uniforms (a torch.Generator by
# default). ``uniforms`` [b, vocab] in (0, 1) may be passed instead, the
# seam the tests use: the two frameworks' random streams differ.


def _gumbel_argmax(logits, generator, uniforms):
    if uniforms is None:
        uniforms = torch.rand(
            logits.shape, generator=generator, device=logits.device
        )
    u = uniforms.to(logits.device, torch.float32).clamp(
        torch.finfo(torch.float32).tiny, 1.0
    )
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _sample(
    logits, generator, temperature: float, top_k: int, top_p: float,
    uniforms=None,
):
    """logits [b, vocab] -> token ids [b]. top-k and nucleus top-p share
    one full-vocab sort: both reduce to a per-row cutoff value in the
    descending order, and the final mask is one compare."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0 or 0.0 < top_p < 1.0:
        ranked = torch.sort(logits, dim=-1, descending=True).values
        if top_k > 0:
            pos = torch.arange(ranked.shape[-1], device=logits.device)
            ranked = torch.where(pos[None] < top_k, ranked, NEG_INF)
        if 0.0 < top_p < 1.0:
            probs = torch.softmax(ranked, dim=-1)
            before = torch.cumsum(probs, dim=-1) - probs
            keep_count = torch.sum(before < top_p, dim=-1)  # [b], >= 1
            cutoff = torch.gather(ranked, -1, keep_count[:, None] - 1)
        else:
            cutoff = ranked[:, top_k - 1][:, None]
        logits = torch.where(logits >= cutoff, logits, NEG_INF)
    return _gumbel_argmax(logits, generator, uniforms)


def _sample_rowwise(
    logits, generator, temperature, top_k, top_p, uniforms=None,
):
    """Per-ROW sampling params: logits [b, vocab], temperature [b] float,
    top_k [b] int (0 = off), top_p [b] float (0 or 1 = off) -> token ids
    [b]. Rows with temperature == 0 take the exact argmax; the rest share
    _sample's one-sort top-k/top-p algebra with per-row cutoffs."""
    greedy = torch.argmax(logits, dim=-1)
    b, vocab = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, device=dev).long()
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    t = temperature.clamp_min(1e-6)[:, None]
    scaled = logits / t
    ranked = torch.sort(scaled, dim=-1, descending=True).values
    pos = torch.arange(vocab, device=dev)
    k_eff = torch.where(top_k > 0, top_k, vocab)[:, None]
    in_k = pos[None] < k_eff
    ranked_k = torch.where(in_k, ranked, NEG_INF)
    probs = torch.softmax(ranked_k, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    p_on = (top_p > 0.0) & (top_p < 1.0)
    p_eff = torch.where(p_on, top_p, 1.0)[:, None]
    keep_count = torch.sum((before < p_eff) & in_k, dim=-1).clamp_min(1)
    cutoff = torch.gather(ranked_k, -1, keep_count[:, None] - 1)
    masked = torch.where(scaled >= cutoff, scaled, NEG_INF)
    sampled = _gumbel_argmax(masked, generator, uniforms)
    return torch.where(temperature <= 0.0, greedy, sampled)


@torch.no_grad()
def generate(
    params: Dict,
    prompt,
    cfg: ModelConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> torch.Tensor:
    """Generate continuations. prompt [b, p] -> [b, p + max_new_tokens]
    (int64). Greedy when temperature == 0, else temperature sampling with
    optional top-k and/or nucleus top-p. Prefill runs the prompt in one
    chunk; decode appends one position per step.

    ``mesh`` (``parallel.make_mesh``): sharded decode, run in every rank
    of the mesh (module docstring). Each rank passes the whole prompt and
    its shards of the params (``parallel.shard_params(full, mesh, cfg,
    decode_shardings(mesh, cfg, full)[0])``), and gets the whole output;
    the batch must split over dp."""
    device = as_device(device)
    _check_device(params, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p = prompt.shape
    total = p + max_new_tokens
    max_len = max_len or total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt + new tokens {total}")
    if cfg.pos == "learned" and cfg.max_seq < max_len:
        raise ValueError(
            f"cfg.max_seq {cfg.max_seq} < requested length {max_len}"
        )
    if max_new_tokens == 0:
        return prompt
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    view, rows, g = None, prompt, cfg.kv_heads
    if mesh is not None:
        view = _decode_view(mesh, cfg, device, b)
        n, g = b // view.dp_size, cfg.kv_heads // view.tp_size
        rows = prompt[view.dp_rank * n:(view.dp_rank + 1) * n]
    # this rank's kv heads (all of them on one device)
    shape = (cfg.n_layers, rows.shape[0], max_len, g, cfg.head_dim)
    cache = KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                    v=torch.zeros(shape, dtype=cfg.dtype, device=device))

    def sample(logits):
        if view is None or temperature == 0.0:
            return _sample(logits, generator, temperature, top_k, top_p)
        u = torch.rand((b, logits.shape[-1]), generator=generator,
                       device=logits.device)
        n = logits.shape[0]
        return _sample(logits, generator, temperature, top_k, top_p,
                       uniforms=u[view.dp_rank * n:(view.dp_rank + 1) * n])

    logits, cache = _forward_chunk(params, rows, cache, cfg, view=view)
    tok = sample(logits[:, -1])
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_chunk(
            params, tok[:, None], cache, cfg, moe_drop_free=True, view=view
        )
        tok = sample(logits[:, -1])
        out.append(tok)
    done = torch.cat([rows, torch.stack(out, dim=1)], dim=1)
    return done if view is None else _gather_axis(done, 0, view.dp)


def _decode_view(mesh, cfg: ModelConfig, device: torch.device,
                 batch: int) -> LocalView:
    """The rank's view for sharded decode: the sequence is whole on every
    rank (sp ranks decode the same rows), the batch split over dp."""
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run on {device}")
    decode_shardings(mesh, cfg)
    view = dataclasses.replace(local_view(mesh), sp_rank=0, sp_size=1)
    if batch % view.dp_size:
        raise ValueError(
            f"batch {batch} does not split over dp={view.dp_size}: size the "
            "batch as a multiple of dp"
        )
    return view


_CACHE_SPEC = (None, "dp", None, "tp", None)


def decode_shardings(mesh, cfg: ModelConfig, params: Optional[Dict] = None
                     ) -> Tuple[Dict, KVCache]:
    """(param split specs, KVCache split specs) for sharded decode (JAX
    ``decode_shardings``): batch over "dp", kv heads over "tp" (cache
    ``[L, b, s, g, h]``). For an int8 tree pass the params: each quantized
    leaf's spec becomes ``{"q": the weight's, "s": the weight's with its
    size-1 (keepdims) axes unsplit}``."""
    tp = axis_size(mesh, "tp")
    if cfg.kv_heads % tp:
        raise AssertionError(
            f"kv_heads {cfg.kv_heads} must divide over tp={tp} "
            "(the cache shards its kv-head axis)"
        )
    specs = full_param_shardings(mesh, cfg)
    if params is not None:
        def leaf(path, x):
            spec = _spec_at(specs, path)
            if is_quantized(x):
                return {"q": spec, "s": scale_spec(spec, x["s"].shape)}
            return spec

        specs = _tree_map(leaf, params)
    return specs, KVCache(k=_CACHE_SPEC, v=_CACHE_SPEC, length=())
