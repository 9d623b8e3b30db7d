"""The flagship transformer pipelined over a "pp" axis, PyTorch port:
GPipe and 1F1B.

Counterpart of ``elastic_tpu_agent/workloads/transformer_pipeline.py``:
the layer stack is split into ``pp`` equal stage groups whose leaves are
stacked ``[pp, L/pp, ...]`` under ``stages``; the embedding runs before
the pipeline and the LM head after it. A stage runs its ``L/pp`` layers
(``_stage_fn``) with the attention core through the port's
``attention.flash_attention``: the flash forward kernel, and the dK/dV
and dQ kernels in its backward, on the card; their plain versions on the
CPU (and the reference attention outside the kernel's shape gate, as the
JAX stage falls back to its einsum oracle).

- ``schedule="gpipe"``: autograd through ``pipeline.pipeline_apply``
  (all forwards, then all backwards; the live set grows with m).
- ``schedule="1f1b"`` (``pipeline_1f1b_grads``): JAX's tick math, stage p
  runs the forward of microbatch i at tick ``i + p`` and its backward at
  ``i + 2 pp - 2 - p``. A tick's forward runs without a graph and stashes
  its stage input (a ``2 pp``-slot buffer: a fresh tensor each, never a
  view of a receive buffer); the backward recomputes the stage forward
  from the stashed input under ``torch.enable_grad()`` and takes
  ``torch.autograd.grad`` of it, so at most one stage graph is live and
  the stash bounds the rest: O(pp) stage inputs instead of GPipe's O(m)
  graphs. The flash forward therefore runs twice per layer and microbatch
  on every stage but the last, whose backward half takes a microbatch in
  the tick its forward half receives it and so runs the recompute alone.
  The head runs on the last stage only (JAX evaluates it masked on every
  stage; the numbers are the same).

The transports are ``pipeline.py``'s: a ``ProcessGroupPipe`` over a
("pp", "dp") mesh (one stage per rank, microbatch rows split over dp) or
a ``StackedPipe`` (every stage in one process).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .attention import auto_flash_config, flash_attention
from .parallel import all_reduce_
from .pipeline import (
    as_pipe,
    dp_rows,
    pipeline_apply,
    shard_stages,
    stage_of,
)
from .quantize import _tree_map
from .transformer import (
    AdamW,
    ModelConfig,
    _leaves,
    _like,
    _rmsnorm,
    as_device,
    rope,
)


def check_pipeline_config(cfg: ModelConfig, pp: int) -> None:
    """JAX ``init_pipeline_params``' asserts, with its messages."""
    if cfg.n_layers % pp:
        raise AssertionError(
            f"n_layers {cfg.n_layers} must divide into pp={pp} stages")
    if cfg.moe_experts != 0:
        raise AssertionError("MoE + pipeline not supported")
    if cfg.is_gqa:
        raise AssertionError(
            "GQA + pipeline not supported: the pipeline stages use fused "
            "wqkv projections (n_kv_heads must equal n_heads)"
        )
    if cfg.pos not in ("learned", "rope"):
        raise AssertionError(cfg.pos)


def init_pipeline_params(cfg: ModelConfig, generator: torch.Generator,
                         pp: int, device="cuda") -> Dict:
    """Random f32 params in the JAX ``init_pipeline_params`` layout
    (normal(0.02) weights, unit norm scales), drawn from ``generator`` on
    the CPU. Parity with JAX goes through
    ``weights.pipeline_params_from_jax``."""
    from .weights import pipeline_layout_shapes

    return _tree_map(
        lambda path, shape: (
            torch.ones(shape) if path[-1].endswith("_scale")
            else torch.randn(shape, generator=generator) * 0.02
        ).to(device),
        pipeline_layout_shapes(cfg, pp),
    )


# -- stage computation -------------------------------------------------------


def _stage_fn(stage_params: Dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """This stage's L/pp layers on x [mb, s, d]; leaves [L/pp, ...]."""
    s = x.shape[1]
    fc = dataclasses.replace(auto_flash_config(s), window=cfg.window)
    for i in range(stage_params["wo"].shape[0]):
        lp = {k: v[i] for k, v in stage_params.items()}
        h = _rmsnorm(x, lp["ln1_scale"])
        qkv = torch.einsum("bsd,dcnh->bcsnh", h, lp["wqkv"].to(cfg.dtype))
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        if cfg.pos == "rope":
            # stages see the whole sequence: local positions are global
            positions = torch.arange(s, device=x.device)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        attn = flash_attention(q, k, v, fc)
        x = x + torch.einsum("bsnh,nhd->bsd", attn, lp["wo"].to(cfg.dtype))
        h = _rmsnorm(x, lp["ln2_scale"])
        h = F.gelu(torch.einsum("bsd,df->bsf", h, lp["w1"].to(cfg.dtype)),
                   approximate="tanh")           # jax.nn.gelu's default
        x = x + torch.einsum("bsf,fd->bsd", h, lp["w2"].to(cfg.dtype))
    return x


def _embed_fn(params: Dict, tokens: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """tokens [m, mb, s] -> activations [m, mb, s, d] in cfg.dtype."""
    s = tokens.shape[-1]
    x = params["embed"].to(cfg.dtype)[tokens]
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(cfg.dtype)[:s][None, None]
    return x


def _head_loss(y: torch.Tensor, head: Dict, targets: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Final norm, LM head (f32 logits) and the mean token cross entropy
    of one microbatch. y [mb, s, d]; targets [mb, s]."""
    h = _rmsnorm(y, head["final_norm_scale"])
    logits = torch.einsum("bsd,dv->bsv", h,
                          head["lm_head"].to(cfg.dtype)).float()
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten())


def _split_head(params: Dict) -> Dict:
    return {"final_norm_scale": params["final_norm_scale"],
            "lm_head": params["lm_head"]}


def _embed_part(params: Dict) -> Dict:
    return {k: params[k] for k in ("embed", "pos_embed") if k in params}


# -- 1F1B --------------------------------------------------------------------


def pipeline_1f1b_grads(
    mesh_or_pipe, cfg: ModelConfig, stage_params: Dict, head_params: Dict,
    xs: torch.Tensor, targets: torch.Tensor,
) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor]:
    """One-forward-one-backward pass (module docstring).

    stage_params: this process's stages' leaves ([1, L/pp, ...] on a
    mesh, [pp, L/pp, ...] stacked); xs: [m, mb, s, d] stage-0 inputs
    (after the embedding; this rank's dp rows); targets: [m, mb, s].
    Returns (stage_grads shaped like stage_params, head_grads, dxs
    [m, mb, s, d] (the cotangent for the embedding's backward) and the
    mean loss), as JAX's: averaged over the microbatches and over dp, the
    head gradients and the loss from the last stage and dxs from stage 0
    made equal on every pp rank, dxs scaled by 1 / (m * dp)."""
    pipe = as_pipe(mesh_or_pipe)
    pp, m = pipe.size, xs.shape[0]
    slots = 2 * pp
    xs = xs.detach()
    like = xs[0]
    stages = [_tree_map(lambda path, a: a.detach().requires_grad_(),
                        stage_of(stage_params, j))
              for j in range(len(pipe.indices))]
    head = _tree_map(lambda path, a: a.detach().requires_grad_(), head_params)
    g_stage = [[torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                for a in _leaves(st)] for st in stages]
    g_head = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
              for a in _leaves(head)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
    dxs = torch.zeros_like(xs)
    stash = {p: [None] * slots for p in pipe.indices}
    fwd_in: Dict[int, torch.Tensor] = {}
    bwd_in: Dict[int, torch.Tensor] = {}

    def f_of(p, t):
        return t - p

    def b_of(p, t):
        return t - (2 * pp - 2 - p)

    for t in range(m + 2 * pp - 2):
        fwd, bwd = {}, {}
        for j, p in enumerate(pipe.indices):
            f = f_of(p, t)
            if 0 <= f < m:                                   # forward half
                x_in = xs[f] if p == 0 else fwd_in[p]
                stash[p][f % slots] = x_in
                if p < pp - 1:  # the last stage's backward half takes f now
                    with torch.no_grad():
                        fwd[p] = _stage_fn(stages[j], x_in, cfg)
            b = b_of(p, t)
            if 0 <= b < m:                                   # backward half
                x_b = stash[p][b % slots].detach().requires_grad_()
                stash[p][b % slots] = None
                with torch.enable_grad():
                    y_b = _stage_fn(stages[j], x_b, cfg)     # the recompute
                    if p == pp - 1:
                        y_d = y_b.detach().requires_grad_()
                        loss_b = _head_loss(y_d, head, targets[b], cfg)
                        seed, *gh = torch.autograd.grad(
                            loss_b, [y_d, *_leaves(head)])
                        torch._foreach_add_(g_head, [g.float() for g in gh])
                        loss_sum = loss_sum + loss_b.detach()
                    else:
                        seed = bwd_in[p]
                    *gs, g_x = torch.autograd.grad(
                        y_b, [*_leaves(stages[j]), x_b], seed)
                torch._foreach_add_(g_stage[j], [g.float() for g in gs])
                if p == 0:
                    dxs[b] = g_x
                else:
                    bwd[p] = g_x
        need_f = {p for p in pipe.indices if p > 0 and 0 <= f_of(p, t + 1) < m}
        need_b = {p for p in pipe.indices
                  if p < pp - 1 and 0 <= b_of(p, t + 1) < m}
        fwd_in, bwd_in = pipe.exchange(fwd, bwd, need_f, need_b, like)

    flat_stage = [g for gs in g_stage for g in gs]
    torch._foreach_div_(flat_stage + g_head, float(m))
    loss = (loss_sum / m).reshape(1)
    pipe.sum_over_pp([*g_head, loss, dxs])       # from the last stage / stage 0
    pipe.mean_over_dp([*flat_stage, *g_head, loss])
    dxs = dxs / (m * pipe.dp_size)
    stage_grads = _restack([_like(st, gs) for st, gs in zip(stages, g_stage)],
                           stage_params)
    return stage_grads, _like(head_params, g_head), dxs, loss[0]


def _restack(per_stage, like: Dict) -> Dict:
    """Per-stage gradient trees stacked on a leading stage axis."""
    leaves = [_leaves(t) for t in per_stage]
    return _like(like, [torch.stack(ls) for ls in zip(*leaves)])


# -- train steps --------------------------------------------------------------


def pipeline_loss_and_grads(
    mesh_or_pipe, cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
    schedule: str = "gpipe",
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the pipelined step on global tokens [m, mb, s+1]
    (this rank takes its dp rows): the mean over microbatches of each
    microbatch's mean cross entropy, and its gradient as a tree shaped like
    ``params`` (this process's stages, the whole embedding and head),
    equal on every rank of the mesh. The train step's work before its
    optimizer update."""
    pipe = as_pipe(mesh_or_pipe)
    toks = dp_rows(tokens, pipe)
    if schedule == "gpipe":
        loss, grads = _gpipe_grads(pipe, cfg, params, toks)
        loss = loss.reshape(1)
        pipe.mean_over_dp([loss, *grads])
        return loss[0], _like(params, grads)
    loss, grads = _one_f_one_b_grads(pipe, cfg, params, toks)
    return loss, _like(params, grads)


def _gpipe_grads(pipe, cfg, params, toks):
    """Autograd through ``pipeline_apply`` (before the mean over dp)."""
    live = _tree_map(lambda path, a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        xs = _embed_fn(live, toks[:, :, :-1], cfg)
        ys = pipeline_apply(
            pipe, lambda sp, x: _stage_fn(sp, x, cfg), live["stages"], xs)
        head = _split_head(live)
        loss = torch.stack([
            _head_loss(ys[i], head, toks[i, :, 1:], cfg)
            for i in range(toks.shape[0])]).mean()
        torch.autograd.backward(loss)
    grads = [a.grad if a.grad is not None else torch.zeros_like(a)
             for a in _leaves(live)]
    # the embedding's gradient lives on stage 0 (the others never read its
    # output); each rank computed the head's whole
    pipe.sum_over_pp(_leaves(_embed_part(_like(params, grads))))
    return loss.detach(), grads


def _one_f_one_b_grads(pipe, cfg, params, toks):
    """``pipeline_1f1b_grads`` and the embedding's backward from its
    dxs."""
    live_embed = _tree_map(lambda path, a: a.detach().requires_grad_(),
                           _embed_part(params))
    with torch.enable_grad():
        xs = _embed_fn(live_embed, toks[:, :, :-1], cfg)
    g_stage, g_head, dxs, loss = pipeline_1f1b_grads(
        pipe, cfg, params["stages"], _split_head(params), xs, toks[:, :, 1:])
    g_embed = _like(live_embed, list(torch.autograd.grad(
        xs, _leaves(live_embed), dxs.to(xs.dtype))))
    if pipe.dp_size > 1:        # each rank's rows' share of the sum
        all_reduce_(_leaves(g_embed), (pipe.dp,))
    grads = {**g_embed, **g_head, "stages": g_stage}
    return loss, _leaves({k: grads[k] for k in params})


def make_pipeline_transformer_step(
    cfg: ModelConfig, mesh_or_pipe, n_micro: int, schedule: str = "gpipe",
    learning_rate: float = 1e-3, device="cuda",
):
    """(train_step, init_all), as JAX's. ``train_step(params, opt_state,
    tokens [n_micro, mb, s+1]) -> (params, opt_state, loss)``: the layer
    stack pipelined over "pp", the microbatch rows split over "dp" (every
    rank passes the global tokens and takes its rows; ``mb`` must split
    over dp), ``optax.adamw(learning_rate)`` as ``AdamW``; ``params`` and
    ``opt_state`` are updated in place. ``params`` holds this process's
    stages (``pipeline.shard_stages``) and the whole embedding and head;
    ``init_all(generator)`` draws them like ``init_pipeline_params``. The
    loss is the mean over microbatches of each microbatch's mean cross
    entropy, the same on every rank."""
    if schedule not in ("gpipe", "1f1b"):
        raise AssertionError(schedule)
    device = as_device(device)
    pipe = as_pipe(mesh_or_pipe)
    check_pipeline_config(cfg, pipe.size)
    optimizer = AdamW(learning_rate)

    def train_step(params, opt_state, tokens):
        toks = torch.as_tensor(tokens, device=device).long()
        if toks.dim() != 3 or toks.shape[0] != n_micro:
            raise ValueError(f"tokens {tuple(toks.shape)}: want [{n_micro}, "
                             "mb, seq+1]")
        loss, grads = pipeline_loss_and_grads(pipe, cfg, params, toks,
                                              schedule)
        optimizer.update_(grads, opt_state, params)
        return params, opt_state, loss

    def init_all(generator: torch.Generator):
        full = init_pipeline_params(cfg, generator, pipe.size, device)
        params = dict(full, stages=shard_stages(full["stages"], pipe))
        return params, optimizer.init(params)

    return train_step, init_all

