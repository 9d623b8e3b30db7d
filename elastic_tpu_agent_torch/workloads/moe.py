"""Switch-style Mixture-of-Experts layer, PyTorch port, one device.

Counterpart of ``elastic_tpu_agent/workloads/moe.py``: top-1 routing with
an f32 router, a fixed per-expert capacity ``C = ceil(T * factor / E)``
whose overflow tokens are dropped (their ``y`` is exactly 0: the caller's
residual carries them), and the Switch load-balancing aux loss.

Where the JAX layer dispatches and combines with one-hot ``[T, E, C]``
einsums (static shapes for XLA), the port indexes: each kept token's row
is gathered into its ``(expert, slot)`` and each token gathers its output
back. Every slot holds at most one token, so the einsums' sums have one
nonzero term and the two forms give the same numbers; the gate is rounded
to the model dtype before it multiplies the expert output, as the JAX
combine is. The expert matmuls are batched ``torch.bmm`` over experts.
Expert-parallel sharding (``moe_param_shardings``, ``mesh=``) comes with
the multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .quantize import wdense


def init_moe_params(
    generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
    device="cuda",
) -> Dict:
    """{"wg": [d,E], "w1": [E,d,ff], "w2": [E,ff,d]} in f32, normal(0.02),
    drawn from ``generator`` on the CPU."""

    def draw(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(device)

    return {
        "wg": draw(d_model, n_experts),
        "w1": draw(n_experts, d_model, d_ff),
        "w2": draw(n_experts, d_ff, d_model),
    }


def expert_capacity(
    n_tokens: int, n_experts: int, capacity_factor: float
) -> int:
    return max(1, math.ceil(n_tokens * capacity_factor / n_experts))


class MoeRoutingStats:
    """Host-side routing observability for the MoE layer: ``observe()``
    re-runs the f32 top-1 router on a batch's inputs (numpy, on the host)
    and accumulates expert load, capacity drops and the aux loss;
    ``stats()`` is the ledger ``ServingEngine.stats()['moe']`` reports.
    Attach an instance as ``engine.moe_stats``."""

    def __init__(self) -> None:
        self.batches = 0
        self.tokens_routed = 0
        self.dropped_tokens = 0
        self._expert_load: Optional[np.ndarray] = None
        self._aux_loss_sum = 0.0

    def observe(
        self, x, params: Dict, capacity_factor: float,
        aux_loss: Optional[float] = None,
    ) -> None:
        """Recompute the top-1 routing decision for one batch [b, s, d]
        (or [t, d]) and fold it into the ledgers."""
        xt = _host_f32(x)
        if xt.ndim == 3:
            xt = xt.reshape(-1, xt.shape[-1])
        wg = _host_f32(params["wg"])
        n_experts = wg.shape[1]
        t = xt.shape[0]
        cap = expert_capacity(t, n_experts, capacity_factor)
        expert_index = np.argmax(xt @ wg, axis=-1)
        load = np.bincount(expert_index, minlength=n_experts)
        if self._expert_load is None:
            self._expert_load = np.zeros(n_experts, dtype=np.int64)
        self._expert_load[: len(load)] += load
        self.batches += 1
        self.tokens_routed += t
        self.dropped_tokens += int(np.maximum(load - cap, 0).sum())
        if aux_loss is not None:
            self._aux_loss_sum += float(aux_loss)

    def stats(self) -> Dict:
        load = self._expert_load
        imbalance = None
        if load is not None and load.sum() > 0:
            imbalance = float(load.max() / max(load.mean(), 1e-9))
        return {
            "experts": 0 if load is None else int(len(load)),
            "batches": self.batches,
            "tokens_routed": self.tokens_routed,
            "dropped_tokens": self.dropped_tokens,
            "drop_rate": (
                round(self.dropped_tokens / self.tokens_routed, 4)
                if self.tokens_routed else None
            ),
            "imbalance": (
                round(imbalance, 4) if imbalance is not None else None
            ),
            "expert_load": (
                [] if load is None else [int(v) for v in load]
            ),
            "aux_loss_mean": (
                round(self._aux_loss_sum / self.batches, 4)
                if self.batches else None
            ),
        }


def _host_f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def route(
    xt: torch.Tensor, wg: torch.Tensor, capacity_factor: float,
) -> Tuple[torch.Tensor, ...]:
    """Top-1 routing of tokens xt [T, d] in f32: (probs [T, E], expert
    [T], slot [T] (0-indexed), kept [T] bool, aux loss). Slots count the
    tokens routed to an expert in token order, in integers; a token
    whose position exceeds the capacity is dropped (kept False, slot 0,
    as the JAX one-hot bookkeeping leaves it)."""
    n_experts = wg.shape[1]
    cap = expert_capacity(xt.shape[0], n_experts, capacity_factor)
    logits = xt.float() @ wg.float()
    probs = torch.softmax(logits, dim=-1)                      # [T, E]
    expert = torch.argmax(probs, dim=-1)                       # [T]
    onehot = F.one_hot(expert, n_experts)                      # int64
    # Switch aux loss from the mask taken BEFORE capacity drops
    density = onehot.float().mean(dim=0)
    aux = n_experts * torch.sum(density * probs.mean(dim=0))
    position = torch.cumsum(onehot, dim=0).gather(1, expert[:, None])[:, 0]
    kept = position <= cap
    slot = torch.where(kept, position - 1, 0)
    return probs, expert, slot, kept, aux


def moe_mlp(
    x: torch.Tensor, params: Dict, capacity_factor: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, s, d] -> ([b, s, d], aux loss f32 0-dim).

    The aux loss is the Switch load-balancing term E * sum_e(f_e * p_e)
    (fraction routed times mean router probability), 1.0 at perfect
    balance; the train step adds it with ``moe_aux_coef``."""
    b, s, d = x.shape
    dtype = x.dtype
    xt = x.reshape(b * s, d)
    n_experts = params["wg"].shape[1]
    cap = expert_capacity(b * s, n_experts, capacity_factor)
    probs, expert, slot, kept, aux = route(xt, params["wg"], capacity_factor)
    gate = torch.where(kept, probs.gather(1, expert[:, None])[:, 0], 0.0)

    # dispatch: slot (e, c) takes its one token's row; a dropped token
    # writes the spare last row, which no expert reads
    flat = torch.where(kept, expert * cap + slot, n_experts * cap)
    xin = xt.new_zeros((n_experts * cap + 1, d)).index_put(
        (flat,), xt
    )[:-1].reshape(n_experts, cap, d)
    h = torch.bmm(xin, wdense(params, "w1", dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = torch.bmm(h, wdense(params, "w2", dtype)).reshape(-1, d)

    # combine: the gate rounded to the model dtype, as the JAX combine is
    picked = out[flat.clamp(max=n_experts * cap - 1)]
    y = torch.where(kept[:, None], gate.to(dtype)[:, None] * picked, 0.0)
    return y.reshape(b, s, d), aux.float()
