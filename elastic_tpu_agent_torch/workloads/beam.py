"""Beam-search decoding over the KV cache, PyTorch port.

Counterpart of ``elastic_tpu_agent/workloads/beam.py``: the beam axis is
the batch axis of one KV cache [L, beam, max_len, g, h]. Prefill runs
once and its cache is copied to every beam; then each step is one
batched single-token forward for all beams, a top-k over the flattened
[beam * vocab] continuation scores, and a gather that reorders the cache
rows to each survivor's parent. The chunk forward writes the cache in
place, so the beams hold materialised copies (an ``expand`` view would
give every beam the same memory) and the reorder gathers into a fresh
tensor.

Ties rank as in JAX: ``lax.top_k`` puts the lower index first among equal
values and the final ``argsort`` is stable, so both rankings here are a
stable descending sort (``torch.topk`` promises no order among ties, and a
frozen beam's one child keeps its parent's score exactly).

EOS (optional): a finished beam is frozen; it proposes exactly one
continuation, itself padded with eos at an unchanged score, so live and
finished hypotheses compete in the same top-k. Length normalisation
(``length_penalty`` = alpha > 0): each hypothesis's score divides by
(5 + its generated length)^alpha / 6^alpha (GNMT), its length stopping at
its first eos; applied at the final ranking only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .attention import NEG_INF
from .generate import KVCache, _forward_chunk
from .transformer import ModelConfig, _check_device, as_device


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest of 1-D x, the lower index first
    among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, descending=True, stable=True)
    return values[:k], indices[:k]


@torch.no_grad()
def beam_search(
    params: Dict,
    prompt,
    cfg: ModelConfig,
    max_new_tokens: int,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    eos_id: Optional[int] = None,
    max_len: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompt [1, p] -> (sequences [beam, p + max_new_tokens] int64,
    scores [beam] f32), best beam first.

    Scores are total token logprobs (length-normalised when
    length_penalty > 0). beam_size=1 is greedy decoding. MoE models decode
    drop-free per step (generate's policy)."""
    device = as_device(device)
    _check_device(params, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.shape[0] != 1:
        raise ValueError("beam search expands ONE prompt")
    _, p = prompt.shape
    total = p + max_new_tokens
    max_len = max_len or total
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt + new tokens {total}")
    if cfg.pos == "learned" and cfg.max_seq < max_len:
        raise ValueError(
            f"cfg.max_seq {cfg.max_seq} < requested length {max_len}"
        )
    k = beam_size
    if max_new_tokens == 0:
        return (
            prompt.expand(k, p).clone(),
            torch.zeros((k,), dtype=torch.float32, device=device),
        )
    has_eos = eos_id is not None

    cache = KVCache.empty(cfg, 1, max_len, device=device)
    logits, cache = _forward_chunk(params, prompt, cache, cfg)
    logp0 = torch.log_softmax(logits[0, -1].float(), dim=-1)
    # beams 0..k-1 start as the top-k first tokens
    scores, first = _top_k(logp0, k)
    cache = KVCache(
        k=cache.k.repeat(1, k, 1, 1, 1), v=cache.v.repeat(1, k, 1, 1, 1),
        length=cache.length,
    )
    buf = torch.zeros((k, total), dtype=torch.long, device=device)
    buf[:, :p] = prompt[0]
    buf[:, p] = first
    finished = (
        first == eos_id if has_eos
        else torch.zeros((k,), dtype=torch.bool, device=device)
    )
    gen_len = torch.ones((k,), dtype=torch.float32, device=device)
    last = first
    if has_eos:
        only_eos = torch.full(
            (cfg.vocab,), NEG_INF, dtype=torch.float32, device=device
        )
        only_eos[eos_id] = 0.0
    for i in range(max_new_tokens - 1):
        logits, cache = _forward_chunk(
            params, last[:, None], cache, cfg, moe_drop_free=True
        )
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1)   # [k, v]
        vocab = logp.shape[-1]
        if has_eos:
            # frozen beams propose exactly one child: themselves padded
            # with eos at an unchanged score
            logp = torch.where(finished[:, None], only_eos, logp)
        cand = scores[:, None] + logp                            # [k, v]
        scores, flat_idx = _top_k(cand.reshape(-1), k)
        parent = flat_idx // vocab
        last = flat_idx % vocab
        # reorder every per-beam row to its parent (fresh tensors)
        cache = KVCache(
            k=cache.k[:, parent], v=cache.v[:, parent], length=cache.length
        )
        buf = buf[parent]
        buf[:, p + 1 + i] = last
        was_finished = finished[parent]
        # eos padding on an already-finished beam is not length
        gen_len = gen_len[parent] + torch.where(was_finished, 0.0, 1.0)
        if has_eos:
            finished = was_finished | (last == eos_id)

    final = scores
    if length_penalty > 0.0:
        final = scores / (
            ((5.0 + gen_len) ** length_penalty) / (6.0 ** length_penalty)
        )
    order = torch.sort(final, descending=True, stable=True).indices
    return buf[order], final[order]
