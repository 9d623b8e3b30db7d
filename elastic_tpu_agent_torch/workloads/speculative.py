"""Speculative decoding, PyTorch port: a small draft model proposes, the
target verifies; decode latency moves toward the draft's, the output
stays the target's.

Counterpart of ``elastic_tpu_agent/workloads/speculative.py``:

- The draft proposes ``gamma`` tokens with its own KV cache (single-token
  steps); the target scores all ``gamma + 1`` positions in ONE chunk.
- Acceptance varies per round, so generation is a loop over a padded
  output buffer, and both KV caches roll back by resetting their length
  only: entries past it are masked and overwritten by the next round's
  writes at the same positions.
- Greedy mode is exact: the stream equals target-only greedy decoding.
  Sampling mode is the Leviathan rule (``accept_resample``): accept draft
  token i with probability min(1, p_i / q_i), on the first rejection
  resample from normalize(max(p - q, 0)), and after a full acceptance draw
  the bonus token from the target's last position.

``accept_resample`` takes its uniforms as arguments; the serving engine's
speculative step (``serving.py``) calls it too. Batch is 1 here, as in
JAX: the latency case speculative decoding serves is one stream.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .generate import KVCache, _forward_chunk, _gumbel_argmax
from .transformer import ModelConfig, _check_device, as_device


class SpecStats(NamedTuple):
    """rounds: verify rounds run; drafted: gamma * rounds proposed;
    accepted: drafted tokens that survived verification and landed in
    the emitted stream."""

    rounds: int
    drafted: int
    accepted: int

    def stats(self) -> dict:
        """The host-side summary, in the shape of ServingEngine.stats()'s
        'speculative' block."""
        rounds, drafted = int(self.rounds), int(self.drafted)
        accepted = int(self.accepted)
        return {
            "rounds": rounds,
            "drafted_tokens": drafted,
            "accepted_tokens": accepted,
            "rejected_tokens": drafted - accepted,
            "acceptance_rate": (
                round(accepted / drafted, 4) if drafted else None
            ),
        }


def probs_rowwise(logits: torch.Tensor, temp: torch.Tensor, vocab: int):
    """Per-row sampling distribution: one-hot argmax for greedy rows
    (temp <= 0: the accept/resample algebra then reduces to exact greedy
    matching), softmax(logits / T) else. logits [..., b, vocab], temp [b]
    (or broadcastable to logits' leading axes)."""
    t = temp.clamp_min(1e-6)[..., None]
    p = torch.softmax(logits / t, dim=-1)
    onehot = F.one_hot(logits.argmax(-1), vocab).to(p.dtype)
    return torch.where((temp <= 0.0)[..., None], onehot, p)


def sample_from_probs(probs: torch.Tensor, generator=None, uniforms=None):
    """Categorical draw from probs [..., vocab] (Gumbel-max on
    log(max(p, 1e-30)), ``jax.random.categorical``'s form)."""
    return _gumbel_argmax(
        torch.log(probs.clamp_min(1e-30)), generator, uniforms
    )


def accept_resample(
    target_p: torch.Tensor,     # [b, gamma + 1, vocab]
    draft_q: torch.Tensor,      # [b, gamma, vocab]
    draft_toks: torch.Tensor,   # [b, gamma] int
    u_accept: torch.Tensor,     # [b, gamma] in [0, 1)
    u_correction: torch.Tensor,  # [b, vocab] in (0, 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leviathan accept/resample for each row: (n_acc [b], the accepted
    prefix length, and correction [b], the token after it).

    Draft token i survives when u_accept[i] < min(1, p_i / q_i); the
    longest surviving prefix is accepted. The correction is drawn (Gumbel
    over ``u_correction``) from normalize(max(p - q, 0)) at the first
    rejected position (from p itself where p == q leaves no residual), or
    from the target's bonus position gamma after a full acceptance. With
    one-hot p and q (greedy rows) it reduces to exact greedy matching."""
    b, gamma = draft_toks.shape
    idx = draft_toks.long()[..., None]
    p_i = torch.gather(target_p[:, :gamma], -1, idx)[..., 0]
    q_i = torch.gather(draft_q, -1, idx)[..., 0]
    ok = u_accept < (p_i / q_i.clamp_min(1e-30)).clamp(max=1.0)
    # longest accepted PREFIX: a rejection cuts everything after it
    n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    cut = n_acc.clamp(max=gamma - 1)
    rows = torch.arange(b, device=target_p.device)
    p_cut, q_cut = target_p[rows, cut], draft_q[rows, cut]
    resid = (p_cut - q_cut).clamp_min(0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rsum > 0, resid / rsum.clamp_min(1e-30), p_cut)
    dist = torch.where(
        (n_acc == gamma)[:, None], target_p[:, gamma], resid
    )
    return n_acc, sample_from_probs(dist, uniforms=u_correction)


@torch.no_grad()
def speculative_generate(
    params: Dict,
    draft_params: Dict,
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    prompt,
    max_new_tokens: int,
    gamma: int = 4,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, SpecStats]:
    """prompt [1, p] -> ([1, p + max_new_tokens] int64, SpecStats).

    Greedy when temperature == 0 (the stream equals generate()'s); else
    speculative sampling, which keeps the target's distribution. The two
    configs must share the vocabulary; both models must be dense."""
    device = as_device(device)
    _check_device(params, device)
    _check_device(draft_params, device)
    prompt = torch.as_tensor(prompt, device=device).long()
    if prompt.shape[0] != 1:
        raise ValueError("speculative decode is single-stream")
    if cfg.vocab != draft_cfg.vocab:
        raise ValueError("vocabularies must match")
    if cfg.moe_experts or draft_cfg.moe_experts:
        raise ValueError("speculative decode supports dense models")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    _, p = prompt.shape
    total = p + max_new_tokens
    # every round may write up to gamma + 1 tokens past the cursor
    buf_len = total + gamma + 1
    max_len = max_len or buf_len
    if max_len < buf_len:
        raise ValueError(f"max_len {max_len} < {buf_len} (prompt + new "
                         "tokens + gamma + 1)")
    for c in (cfg, draft_cfg):
        if c.pos == "learned" and c.max_seq < max_len:
            raise ValueError(
                f"cfg.max_seq {c.max_seq} < requested length {max_len}"
            )
    if max_new_tokens == 0:
        return prompt, SpecStats(0, 0, 0)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    temp = torch.tensor([temperature], dtype=torch.float32, device=device)

    def probs_of(logits):        # [1, vocab] or [1, t, vocab]
        return probs_rowwise(
            logits, temp if logits.dim() == 2 else temp[:, None], cfg.vocab)

    tcache = KVCache.empty(cfg, 1, max_len, device=device)
    dcache = KVCache.empty(draft_cfg, 1, max_len, device=device)
    tlogits, tcache = _forward_chunk(params, prompt, tcache, cfg)
    _, dcache = _forward_chunk(draft_params, prompt, dcache, draft_cfg)
    buf = torch.zeros((buf_len,), dtype=torch.long, device=device)
    buf[:p] = prompt[0]
    buf[p] = sample_from_probs(probs_of(tlogits[:, -1]), generator)[0]
    # cursor: the next slot to fill; buf[cursor - 1] is the last committed
    # token, which each round re-feeds as its chunk head
    cursor, rounds, accepted = p + 1, 0, 0
    while cursor < total:
        last = buf[cursor - 1:cursor]
        # -- the draft proposes gamma tokens ---------------------------
        tok, draft_toks, draft_q = last, [], []
        for _ in range(gamma):
            logits, dcache = _forward_chunk(
                draft_params, tok[None], dcache, draft_cfg
            )
            q = probs_of(logits[:, -1])
            tok = sample_from_probs(q, generator)
            draft_toks.append(tok)
            draft_q.append(q)
        # the loop cached [last, d_1 .. d_{gamma-1}] but never fed
        # d_gamma: a fully accepted round needs its entry next round (on a
        # partial accept it lies past the rolled-back length)
        _, dcache = _forward_chunk(
            draft_params, tok[None], dcache, draft_cfg
        )
        draft_toks = torch.stack(draft_toks, dim=1)      # [1, gamma]
        draft_q = torch.stack(draft_q, dim=1)            # [1, gamma, V]
        # -- the target verifies all gamma + 1 positions in one chunk --
        chunk = torch.cat([last[None], draft_toks], dim=1)
        tlogits, tcache = _forward_chunk(params, chunk, tcache, cfg)
        u_accept = torch.rand(
            (1, gamma), generator=generator, device=device
        )
        u_correction = torch.rand(
            (1, cfg.vocab), generator=generator, device=device
        )
        n_acc, correction = accept_resample(
            probs_of(tlogits), draft_q, draft_toks, u_accept, u_correction
        )
        n_acc = int(n_acc[0])
        # -- commit the accepted drafts, then the correction -----------
        buf[cursor:cursor + n_acc] = draft_toks[0, :n_acc]
        buf[cursor + n_acc] = correction[0]
        # the last round may overshoot the budget: count only accepted
        # drafts that land in the emitted stream
        accepted += min(n_acc, total - cursor)
        rounds += 1
        cursor += n_acc + 1
        # -- roll both caches back to the committed stream -------------
        tcache = KVCache(k=tcache.k, v=tcache.v, length=cursor - 1)
        dcache = KVCache(k=dcache.k, v=dcache.v, length=cursor - 1)
    stats = SpecStats(rounds=rounds, drafted=rounds * gamma,
                      accepted=accepted)
    return buf[None, :total], stats
