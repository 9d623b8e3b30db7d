"""Autoregressive generation with a KV cache, PyTorch port.

Counterpart of ``elastic_tpu_agent/workloads/generate.py``: the same
``KVCache`` layout ([n_layers, b, max_len, kv_heads, h]), the same chunk
forward (plain and per-row ``positions=`` modes), the same sampling
algebra. Where JAX returns an updated cache from a pure function, the port
writes the cache tensors in place and returns them; the decode loop is a
Python loop (PyTorch runs eagerly, so there is no scan to compile).

The cached attention is materialised-scores ``einsum`` over the cache, as
in the JAX package (no Pallas kernel there either). MoE layers take the
JAX capacity policy: a prefill chunk routes with the training capacity
factor, drops included; a decode step is drop-free. Streaming ring caches
come with a later slice and raise; so does mesh decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from .attention import NEG_INF
from .moe import moe_mlp
from .quantize import embed_lookup, wdense
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
) -> torch.Tensor:
    """Causal attention of the chunk against the masked full cache, at
    kv_heads width: q is viewed as [b, t, g, r, h] (contiguous groups)."""
    b, t, n, h = q.shape
    g = cfg.kv_heads
    r = n // g
    q5 = q.reshape(b, t, g, r, h)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("btgrh,bsgh->bgrts", q5, cache_k).float() * scale
    max_len = cache_k.shape[1]
    q_pos = torch.as_tensor(q_pos, device=q.device)
    rows = q_pos[..., None, None] + torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(max_len, device=q.device)
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


def _forward_chunk(
    params: Dict, tokens: torch.Tensor, cache: KVCache, cfg: ModelConfig,
    moe_drop_free: bool = False,
    positions: Optional[torch.Tensor] = None, ring=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run a token chunk [b, t] at positions cache.length..+t; returns
    (logits [b, t, vocab] f32, the cache, written in place).

    moe_drop_free selects the MoE capacity policy (a one-token chunk is
    not necessarily a decode step: a batch of one-token prompts is still
    prefill): False = the training capacity factor, the forward's
    semantics, drops included; True = capacity T, no token dropped.

    positions: per-row [b] start offsets (continuous-batching decode,
    each slot at its own depth): writes, RoPE, learned positions and the
    mask go row-wise, and the returned length is UNCHANGED (the caller
    owns per-row lengths)."""
    if ring is not None:
        raise NotImplementedError(
            "ring-buffer (streaming) decode comes with a later slice"
        )
    b, t = tokens.shape
    dev = tokens.device
    pos = cache.length if positions is None else positions
    x = embed_lookup(params, tokens, cfg.dtype)
    if positions is None:
        posmat = pos + torch.arange(t, device=dev)                  # [t]
    else:
        posmat = pos.long()[:, None] + torch.arange(t, device=dev)[None]
    if cfg.pos == "learned":
        pe = params["pos_embed"].to(cfg.dtype)[posmat]
        x = x + (pe[None] if posmat.dim() == 1 else pe)

    for i, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["ln1_scale"])
        q, k_c, v_c = _qkv(h, layer, cfg)
        if cfg.pos == "rope":
            # rotated keys go INTO the cache (absolute rotations)
            q = rope(q, posmat, cfg.rope_theta)
            k_c = rope(k_c, posmat, cfg.rope_theta)
        _cache_write(cache.k[i], k_c.to(cache.k.dtype), pos)
        _cache_write(cache.v[i], v_c.to(cache.v.dtype), pos)
        attn = _cached_attention(q, cache.k[i], cache.v[i], pos, cfg)
        x = x + torch.einsum(
            "btnh,nhd->btd", attn, wdense(layer, "wo", cfg.dtype)
        )
        h2 = _rmsnorm(x, layer["ln2_scale"])
        x = x + _chunk_mlp(h2, layer, cfg, moe_drop_free)
    x = _rmsnorm(x, params["final_norm_scale"])
    logits = torch.einsum(
        "btd,dv->btv", x, wdense(params, "lm_head", cfg.dtype)
    ).float()
    new_len = cache.length + t if positions is None else cache.length
    return logits, KVCache(k=cache.k, v=cache.v, length=new_len)


def _chunk_mlp(
    h: torch.Tensor, layer: Dict, cfg: ModelConfig, moe_drop_free: bool,
) -> torch.Tensor:
    """The layer's MLP on a normed chunk [b, t, d]: dense, or MoE with the
    capacity policy ``moe_drop_free`` picks (factor E: capacity T)."""
    if "moe" not in layer:
        return _mlp(h, layer, cfg)
    factor = (
        float(cfg.moe_experts) if moe_drop_free else cfg.moe_capacity_factor
    )
    return moe_mlp(h, layer["moe"], factor)[0]


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
) -> torch.Tensor:
    """Generate continuations. prompt [b, p] -> [b, p + max_new_tokens]
    (int64). Greedy when temperature == 0, else temperature sampling with
    optional top-k and/or nucleus top-p. Prefill runs the prompt in one
    chunk; decode appends one position per step. Single device: mesh
    decode comes with the multi-GPU slice."""
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
    cache = KVCache.empty(cfg, b, max_len, device=device)
    logits, cache = _forward_chunk(params, prompt, cache, cfg)
    tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_chunk(
            params, tok[:, None], cache, cfg, moe_drop_free=True
        )
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
