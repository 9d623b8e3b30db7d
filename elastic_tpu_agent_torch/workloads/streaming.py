"""Streaming decode, PyTorch port: unbounded-length generation for
sliding-window models with a KV cache of FIXED size (O(window) device
memory, not O(generated length)).

Counterpart of ``elastic_tpu_agent/workloads/streaming.py``. A window
model (``ModelConfig.window`` > 0) only attends its last ``window``
positions, so the cache is a ring of exactly ``window`` slots: position P
writes slot P % window, over the key that just slid out of every future
query's reach. A slot-to-position map feeds the mask (the chunk forward's
``ring=`` mode) and RoPE rotates by absolute position, so the stream is
the computation a full cache would do. The decode loop is a Python loop
where JAX has one ``lax.scan``; the cached attention is the same
``einsum`` as ``generate.py``'s, with no kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .generate import KVCache, _forward_chunk, _sample
from .transformer import ModelConfig, _check_device, as_device

# Unwritten ring slots: an absolute position no query reaches, so the
# mask's `cols <= rows` drops them at any stream length. A plain int.
_UNWRITTEN = 2**30


@torch.no_grad()
def streaming_generate(
    params: Dict,
    prompt,
    cfg: ModelConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """prompt [b, p] -> [b, p + max_new_tokens] (int64), with the cache
    fixed at ``cfg.window`` slots whatever max_new_tokens is.

    Needs cfg.window > 0 (with full attention, evicting old keys would
    change the computation) and cfg.pos == "rope" (a learned position
    table bounds the stream at cfg.max_seq). The prompt must fit the
    window; MoE layers decode drop-free, as in generate()."""
    if cfg.window <= 0:
        raise ValueError(
            "streaming decode needs a sliding-window model (cfg.window)"
        )
    if cfg.pos != "rope":
        raise ValueError(
            "streaming decode needs rope (a learned position table bounds "
            "the stream at cfg.max_seq)"
        )
    device = as_device(device)
    _check_device(params, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, p = prompt.shape
    ring_len = cfg.window
    if p > ring_len:
        raise ValueError(
            f"prompt ({p}) must fit the attention window ({ring_len})"
        )
    if max_new_tokens == 0:
        return prompt
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    # prefill: p <= ring_len, no wrap, so slot j holds position j and the
    # plain chunk forward is the ring forward
    cache = KVCache.empty(cfg, b, ring_len, device=device)
    logits, cache = _forward_chunk(params, prompt, cache, cfg)
    tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
    slots = torch.arange(ring_len, device=device)
    key_pos = torch.where(slots < p, slots, _UNWRITTEN)
    out = [tok]
    # prefill's sample is token 1; max_new_tokens - 1 steps emit the rest
    for pos in range(p, p + max_new_tokens - 1):
        slot = pos % ring_len
        key_pos[slot] = pos
        # the cache length carries the ABSOLUTE position (rope, mask
        # rows); the ring pair redirects the write and the mask columns
        logits, cache = _forward_chunk(
            params, tok[:, None],
            KVCache(k=cache.k, v=cache.v, length=pos), cfg,
            moe_drop_free=True, ring=(slot, key_pos),
        )
        tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
