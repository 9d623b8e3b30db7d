"""Flagship decoder-only transformer LM, PyTorch port: forward, train step
and eval.

Counterpart of ``elastic_tpu_agent/workloads/transformer.py``: the same
config fields, the same parameter tree (``weights.params_from_jax`` loads a
JAX ``init_params`` tree, axis layout kept), the same layer body. Plain
functions on a dict of tensors, as the JAX code is functions on a pytree.
The attention core is the Hopper flash kernel (forward and backward)
wherever its gate admits the shape (head_dim 64 or 128); the projections
and MLP stay ``torch.einsum``, as the JAX package leaves them to XLA.

``make_train_step`` is the JAX train step: the shifted
cross entropy, autograd for ``jax.value_and_grad``, optax's ``adamw`` as
``AdamW``, gradient accumulation, the parameter EMA and f32 master
weights. ``make_eval_fn`` is the eval loss.

Every ``moe_every``-th layer of a model with ``moe_experts`` > 0 is a
Switch MoE layer (``moe.py``), whose aux loss the forward sums; under a
mesh its experts are split over "ep" (and their hidden axis over "tp"),
with the routing of the global batch (``moe.py`` says how).

``make_train_step(..., mesh=)`` and ``make_eval_fn(..., mesh=)`` are the
JAX step over a dp/sp/tp mesh (``parallel.make_mesh``), run SPMD: one rank
per device, each holding local shards of the params, gradients and
optimizer state (``parallel.py`` says why and how). Tensor parallelism
splits heads, the FF hidden axis and the vocabulary with explicit
autograd-aware collectives on the tp group; sequence parallelism runs the
ring (``ring_attention.py``) over the sp group; expert parallelism
splits MoE experts over the ep group; ``zero1`` cuts the optimizer state
over dp. ``mesh=None`` is the single-device path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .attention import (
    auto_flash_config,
    flash_attention,
    reference_attention,
    supports_flash,
)
from .moe import moe_mlp
from .parallel import (  # noqa: F401 - make_mesh: JAX keeps it here
    LocalView,
    Zero1,
    all_reduce_,
    copy_to,
    full_param_shardings,
    local_view,
    make_mesh,
    reduce_from,
    shard_params,
    vocab_parallel_nll_sum,
)
from .quantize import embed_lookup, is_quantized, wdense
from .ring_attention import ring_attention
from .telemetry import SPANS
from .weights import _tree_map, jax_layout_shapes


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32768
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: Any = torch.bfloat16
    # Grouped-query attention: number of shared k/v heads (0 = MHA).
    n_kv_heads: int = 0
    # Position encoding: "learned" (table added to embeddings) or "rope".
    pos: str = "learned"
    rope_theta: float = 10000.0
    # Sliding-window attention: each token attends only the last
    # ``window`` positions (0 = full causal).
    window: int = 0
    # Attention core: "auto" picks the ring when the mesh shards the
    # sequence (sp > 1), the flash kernel when its gate admits the shape,
    # the materialised-scores einsum otherwise; "flash", "ring" and
    # "reference" force one.
    attn: str = "auto"
    # Recompute each layer in the backward (torch.utils.checkpoint, as
    # jax.checkpoint): more FLOPs for fewer saved activations. Only acts
    # where autograd records the forward.
    remat: bool = False
    # Mixture-of-Experts: with moe_experts > 0, every ``moe_every``-th
    # layer replaces its dense MLP with a Switch MoE layer (moe.py).
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    def __post_init__(self):
        if self.attn not in ("auto", "flash", "ring", "reference"):
            raise ValueError(f"unknown attn {self.attn!r}")
        if self.pos not in ("learned", "rope"):
            raise ValueError(f"unknown pos {self.pos!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def is_gqa(self) -> bool:
        return self.kv_heads != self.n_heads

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and i % self.moe_every == (
            self.moe_every - 1
        )


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda", dtype=None,
) -> Dict:
    """Random params in the JAX ``init_params`` layout (normal(0.02)
    weights, unit norm scales), drawn from ``generator`` on the CPU and
    stored in ``dtype`` (default cfg.dtype) on ``device``. For convenience
    only: parity with the JAX package always goes through
    ``weights.params_from_jax``."""

    def draw(shape):
        return torch.randn(shape, generator=generator) * 0.02

    tree = _tree_map(
        lambda path, shape: (
            torch.ones(shape) if path[-1].endswith("_scale") else draw(shape)
        ),
        jax_layout_shapes(cfg),
    )
    return _tree_map(
        lambda path, t: t.to(device=device, dtype=dtype or cfg.dtype), tree
    )


# -- model ---------------------------------------------------------------


def rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """Rotary position embedding. x: [b, s, n, h] (h even); positions:
    [s] shared across the batch, or [b, s] per row. Interleaved pairs
    (x[2i], x[2i+1]) rotate by pos * theta^(-2i/h), in f32."""
    h = x.shape[-1]
    freqs = theta ** (
        -torch.arange(0, h, 2, dtype=torch.float32, device=x.device) / h
    )
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack(
        [x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1
    ).reshape(x.shape)
    return out.to(x.dtype)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
    view: Optional[LocalView] = None,
) -> torch.Tensor:
    """Dispatch the attention core: q [b,s,n,h], k/v [b,s,g,h] ->
    [b,s,n,h] (local shards under a mesh). The flash kernel reads grouped
    kv heads in place; the reference path repeats them, as the JAX layer
    body does. A sequence sharded over sp > 1 runs the ring: under "auto",
    as in JAX, and under "reference" too, with the ring's einsum blocks
    (JAX's partitioner gathers the sequence instead; the function is the
    same)."""
    s, h = q.shape[1], q.shape[3]
    sp = view.sp_size if view is not None else 1
    impl = cfg.attn
    if impl == "auto":
        impl = (
            "ring" if sp > 1
            else "flash" if supports_flash(s, h)
            else "reference"
        )
    if impl == "ring" or (impl == "reference" and sp > 1):
        if cfg.window > 0:
            raise ValueError(
                "sliding-window attention is not supported with ring/sp "
                "sharding; use sp=1 (flash handles long windows with "
                "O(window) compute per query)"
            )
        if view is None:
            raise ValueError("ring attention needs a mesh (sp axis)")
        return ring_attention(
            q, k, v, view.ring, flash=False if impl == "reference" else None)
    if impl == "flash":
        if sp > 1:
            raise ValueError(
                "flash attention cannot span a sharded sequence axis; "
                "use ring (attn='ring'/'auto') when sp > 1"
            )
        fc = dataclasses.replace(auto_flash_config(s), window=cfg.window)
        return flash_attention(q, k, v, fc)
    return reference_attention(q, k, v, causal=True, window=cfg.window)


def _attention(
    x: torch.Tensor, layer: Dict, cfg: ModelConfig,
    view: Optional[LocalView] = None, offset: int = 0,
) -> torch.Tensor:
    """Self-attention of x [b, s, d]. Under a mesh the projections hold
    this rank's heads (column split, ``copy_to`` in front) and ``wo``'s
    partial sums are all-reduced over tp (``reduce_from``); ``offset`` is
    the global position of x's first token (its sp chunk's start)."""
    if view is not None:
        x = copy_to(x, view.tp)
    if "wq" in layer:  # GQA: separate q and shared-kv projections
        q = torch.einsum("bsd,dnh->bsnh", x, wdense(layer, "wq", cfg.dtype))
        kv = torch.einsum(
            "bsd,dcgh->bcsgh", x, wdense(layer, "wkv", cfg.dtype)
        )
        k, v = kv[:, 0], kv[:, 1]
    else:
        qkv = torch.einsum(
            "bsd,dcnh->bcsnh", x, wdense(layer, "wqkv", cfg.dtype)
        )
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [b, s, n, h]
    if cfg.pos == "rope":
        positions = torch.arange(offset, offset + x.shape[1], device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)  # at kv width, cheaper
    out = _attention_core(q, k, v, cfg, view)
    out = torch.einsum("bsnh,nhd->bsd", out, wdense(layer, "wo", cfg.dtype))
    return out if view is None else reduce_from(out, view.tp)


def _mlp(
    x: torch.Tensor, layer: Dict, cfg: ModelConfig,
    view: Optional[LocalView] = None,
) -> torch.Tensor:
    if view is not None:
        x = copy_to(x, view.tp)
    h = torch.einsum("bsd,df->bsf", x, wdense(layer, "w1", cfg.dtype))
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, wdense(layer, "w2", cfg.dtype))
    return out if view is None else reduce_from(out, view.tp)


def _check_device(params: Dict, device: torch.device) -> None:
    embed = params["embed"]
    where = (embed["q"] if is_quantized(embed) else embed).device
    if where != device:
        raise ValueError(
            f"params live on {where}, the call asked for {device}; load "
            "them with weights.params_from_jax(..., device=...)"
        )


def as_device(device) -> torch.device:
    """torch.device for ``device``; a bare "cuda" means the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def forward_with_aux(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(token logits [b, s, vocab] in cfg.dtype, the MoE layers' summed
    aux loss: 0.0 for dense models). Runs on ``device``, where ``params``
    must already live. Differentiable: autograd records a graph only when
    a parameter requires grad, so bridged serving params run without
    one."""
    device = as_device(device)
    _check_device(params, device)
    tokens = torch.as_tensor(tokens, device=device).long()
    return _forward(params, tokens, cfg, device)


def _forward(
    params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
    device: torch.device, view: Optional[LocalView] = None, offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward_with_aux's body. Under a mesh (``view``) tokens are this
    rank's chunk, starting at global position ``offset``, and the logits
    are its vocabulary slice of ``lm_head``'s tp split."""
    _, s = tokens.shape
    x = embed_lookup(params, tokens, cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"].to(cfg.dtype)[offset:offset + s][None]

    zero = torch.zeros((), dtype=torch.float32, device=device)

    def layer_fn(x, layer):
        x = x + _attention(
            _rmsnorm(x, layer["ln1_scale"]), layer, cfg, view, offset)
        h = _rmsnorm(x, layer["ln2_scale"])
        if "moe" in layer:
            y, aux = moe_mlp(h, layer["moe"], cfg.moe_capacity_factor, view)
        else:
            y, aux = _mlp(h, layer, cfg, view), zero
        return x + y, aux

    aux_total = zero
    for layer in params["layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x, aux = layer_fn(x, layer)
        aux_total = aux_total + aux
    x = _rmsnorm(x, params["final_norm_scale"])
    if view is not None:
        x = copy_to(x, view.tp)
    logits = torch.einsum(
        "bsd,dv->bsv", x, wdense(params, "lm_head", cfg.dtype)
    )
    return logits, aux_total


def forward(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> torch.Tensor:
    """Token logits (aux loss discarded; see forward_with_aux)."""
    return forward_with_aux(params, tokens, cfg, device)[0]


# -- training step ---------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda path, t: out.append(t), tree)
    return out


def _like(tree, leaves) -> Dict:
    """A tree shaped like ``tree`` holding ``leaves`` in _leaves order."""
    it = iter(leaves)
    return _tree_map(lambda path, _: next(it), tree)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy on f32 logits (optax's
    softmax_cross_entropy_with_integer_labels, then the mean)."""
    return F.cross_entropy(
        logits.float().flatten(0, 1), targets.flatten(), reduction="mean"
    )


def loss_and_grads(
    params: Dict, tokens, cfg: ModelConfig, device="cuda",
) -> Tuple[torch.Tensor, Dict]:
    """(loss, grads) of the train step's loss on tokens [b, seq+1]: the
    mean cross entropy of the shifted targets plus moe_aux_coef * aux, and
    its gradient as a tree shaped like ``params`` in each leaf's dtype
    (``jax.value_and_grad(loss_fn)`` in the JAX ``make_train_step``). The
    caller's tensors are left as they are: the gradient is taken through
    aliases that require grad. Writes a ``train.forward`` and a
    ``train.backward`` span."""
    device = as_device(device)
    fwd = SPANS.open("train.forward")
    tokens = torch.as_tensor(tokens, device=device).long()
    live = _tree_map(lambda path, p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits, aux = forward_with_aux(live, tokens[:, :-1], cfg, device)
        loss = _nll(logits, tokens[:, 1:]) + cfg.moe_aux_coef * aux
        SPANS.close(fwd)
        bwd = SPANS.open("train.backward")
        grads = torch.autograd.grad(loss, _leaves(live))
        SPANS.close(bwd)
    return loss.detach(), _like(params, grads)


def _local_chunk(tokens: torch.Tensor, view: LocalView):
    """(inputs, targets, offset, count): this rank's dp rows and sp
    positions of tokens [B, seq+1] (the inputs tokens[:, :-1] and the
    targets tokens[:, 1:] cut alike), its chunk's global start and the
    global count B * seq that the loss's mean divides by."""
    rows, seq = tokens.shape[0], tokens.shape[1] - 1
    if rows % view.dp_size or seq % view.sp_size:
        raise ValueError(
            f"tokens {tuple(tokens.shape)}: the batch must split over "
            f"dp={view.dp_size} and seq over sp={view.sp_size}"
        )
    b, s = rows // view.dp_size, seq // view.sp_size
    mine = tokens[view.dp_rank * b:(view.dp_rank + 1) * b]
    off = view.sp_rank * s
    return mine[:, off:off + s], mine[:, off + 1:off + s + 1], off, rows * seq


def _local_loss_and_grads(
    params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
    device: torch.device, view: LocalView,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """This rank's term of the global loss (its tokens' cross entropy
    summed over the global token count, plus its share of moe_aux_coef *
    aux) and its gradient leaves, before the sum over dp and sp. The MoE
    aux loss is the global batch's on every rank, and its gradient reaches
    only the rank's own tokens' router probabilities: the gradient takes
    the whole term, the returned value 1 / (dp * sp) of it, so that the
    sum over dp and sp counts it once. Writes a ``train.forward`` and a
    ``train.backward`` span."""
    fwd = SPANS.open("train.forward")
    inputs, targets, off, count = _local_chunk(tokens, view)
    live = _tree_map(lambda path, p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits, aux = _forward(live, inputs, cfg, device, view, off)
        nll = vocab_parallel_nll_sum(logits, targets, view) / count
        loss = nll + cfg.moe_aux_coef * aux
        SPANS.close(fwd)
        bwd = SPANS.open("train.backward")
        grads = torch.autograd.grad(loss, _leaves(live))
        SPANS.close(bwd)
    if not cfg.moe_experts:
        return loss.detach(), list(grads)
    share = cfg.moe_aux_coef * aux.detach() / (view.dp_size * view.sp_size)
    return nll.detach() + share, list(grads)


def _mesh_view(mesh, cfg: ModelConfig, device: torch.device) -> LocalView:
    if mesh.device_type != device.type:
        raise ValueError(
            f"a {mesh.device_type} mesh cannot run on {device}")
    ep = mesh.shape[mesh.mesh_dim_names.index("ep")]
    if cfg.moe_experts and cfg.moe_experts % ep:
        raise ValueError(
            f"moe_experts {cfg.moe_experts} must split over ep={ep} (each "
            "ep rank holds an equal share of the experts)"
        )
    full_param_shardings(mesh, cfg)    # JAX's GQA check
    return local_view(mesh)


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamW:
    """``optax.adamw(learning_rate)`` as the JAX train step builds it
    (b1 0.9, b2 0.999, eps 1e-8 added outside the square root, weight
    decay 1e-4 on every leaf (``weight_decay=0.0`` is ``optax.adam``),
    bias correction from the step count,
    ``learning_rate`` a float or a schedule ``count -> lr``), chained, for
    ``ema_decay`` > 0, with the parameter EMA of the JAX ``EmaState``
    stage, and holding the f32 masters under ``master_weights``.

    The state is a plain dict of tensors, as optax's is a tree: ``count``
    (int32, kept on the host so the bias correction and a schedule read
    it without waiting on the device), ``mu`` and ``nu`` (trees like the
    params), then ``ema`` (the EmaState's tree) and ``masters`` (f32)
    where enabled. ``update_`` applies one step in place.

    ``zero1`` (a ``parallel.Zero1``) cuts ``mu``, ``nu``, ``ema`` and
    ``masters`` over the data-parallel ranks, each leaf along its
    ``zero1_axis`` (leaves without one stay whole): a rank updates its
    slice of each target, then the fresh slices are all-gathered over dp
    into the full params."""

    # optax.adamw's defaults; weight decay is 1e-4 there, not torch's 1e-2
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(
        self, learning_rate: Union[float, Callable[[int], float]] = 1e-3,
        ema_decay: float = 0.0, master_weights: bool = False,
        zero1: Optional[Zero1] = None, weight_decay: float = 1e-4,
    ):
        if not 0.0 <= ema_decay < 1.0:
            # decay 1.0 would freeze the EMA at its init forever
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        self.weight_decay = weight_decay   # 0.0: optax.adam
        self.learning_rate = learning_rate
        self.ema_decay = ema_decay
        self.master_weights = master_weights
        self.zero1 = zero1

    def _parts(self, tree, axes) -> List[torch.Tensor]:
        """``tree``'s leaves, each narrowed to this dp rank's slice where
        ZeRO-1 cuts it (views)."""
        leaves = _leaves(tree)
        if self.zero1 is None:
            return leaves
        return [self.zero1.part(a, x) for a, x in zip(axes, leaves)]

    def init(self, params: Dict) -> Dict:
        """Optimizer state for ``params`` as stored (``cfg.dtype`` live
        leaves under master_weights, whose f32 masters it copies)."""
        base = params
        if self.master_weights:
            base = _tree_map(lambda path, p: p.detach().float(), params)
        if self.zero1 is not None:
            axes = self.zero1.axes(params)
            base = _like(base, [x.clone() for x in self._parts(base, axes)])
        state = {
            "count": torch.zeros((), dtype=torch.int32),
            "mu": _tree_map(lambda path, p: torch.zeros_like(p), base),
            "nu": _tree_map(lambda path, p: torch.zeros_like(p), base),
        }
        if self.ema_decay > 0.0:
            state["ema"] = _tree_map(lambda path, p: p.detach().clone(), base)
        if self.master_weights:
            state["masters"] = base
        return state

    @torch.no_grad()
    def update_(self, grads: Dict, state: Dict, params: Dict) -> None:
        """One AdamW step from ``grads``, in place on ``state`` and
        ``params`` (the JAX step donates both). Under master_weights the
        f32 masters take the update and the live leaves are re-rounded
        from them."""
        count = int(state["count"])
        lr = (
            self.learning_rate(count) if callable(self.learning_rate)
            else self.learning_rate
        )
        # f32 bias corrections from the incremented count, as optax
        bc1 = _f32(1.0 - np.float32(self.b1) ** np.float32(count + 1))
        bc2 = _f32(1.0 - np.float32(self.b2) ** np.float32(count + 1))
        axes = self.zero1.axes(params) if self.zero1 is not None else None
        targets = (_leaves(state["masters"]) if self.master_weights
                   else self._parts(params, axes))
        gs = self._parts(grads, axes)
        if self.master_weights:
            gs = [g.float() for g in gs]
        mus, nus = _leaves(state["mu"]), _leaves(state["nu"])
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, targets, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(targets, upd)
        if self.ema_decay > 0.0:
            ema = _leaves(state["ema"])
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, targets, alpha=1.0 - self.ema_decay)
        live = _leaves(params)
        if self.zero1 is not None:
            self.zero1.gather_(live, targets, axes)
        if self.master_weights:
            whole = [i for i in range(len(live)) if axes is None or
                     axes[i] is None]
            if whole:
                torch._foreach_copy_([live[i] for i in whole],
                                     [targets[i] for i in whole])
        state["count"] += 1


def ema_params(opt_state: Dict) -> Optional[Dict]:
    """The EMA tree of an optimizer state built with ema_decay > 0 (None
    without): the JAX package's ``EmaState.ema``."""
    return opt_state.get("ema")


def make_train_step(
    cfg: ModelConfig,
    learning_rate: Union[float, Callable[[int], float]] = 1e-3,
    accum_steps: int = 1, ema_decay: float = 0.0,
    master_weights: bool = False, zero1: bool = False, device="cuda",
    mesh=None,
):
    """(train_step, init_all, optimizer), as the JAX ``make_train_step``
    returns them.

    ``train_step(params, opt_state, tokens) -> (params, opt_state, loss)``
    takes tokens [batch, seq+1] (targets are the shift by one), or
    [accum_steps, batch, seq+1] when ``accum_steps`` > 1: then the f32
    gradients of the micro-batches are summed, their mean is cast back to
    each param's dtype (not under master_weights, whose f32 optimizer
    takes the f32 mean) and one optimizer update applies it; the loss is
    the micro-batches' mean. MoE layers route and cap each micro-batch on
    its own, so aux losses and capacity drops are micro-batch local, as in
    the JAX step. The step UPDATES ``params`` and ``opt_state``
    IN PLACE (the JAX step donates both) and returns the same objects;
    the loss is a 0-dim f32 tensor on the device.

    ``init_all(generator)`` draws params like ``init_params`` and stores
    them as the JAX step does: f32, or cfg.dtype live leaves under
    ``master_weights``. ``optimizer`` is the ``AdamW``; its ``init(params)``
    starts the state for params loaded another way (the weight bridge with
    ``dtype=torch.float32``). ``learning_rate``, ``ema_decay`` and
    ``master_weights`` are those of the JAX step.

    ``mesh`` (``parallel.make_mesh``; its device type must be
    ``device``'s) runs the step SPMD in every rank of the mesh. Each rank
    passes the same global tokens and takes its dp rows and its sp chunk of
    the positions; params (``parallel.shard_params`` of a full tree, or
    ``init_all``'s, drawn whole from the same generator on every rank and
    cut) and the optimizer state are this rank's shards. The gradients
    are summed over dp and sp, so that they are those of the global mean,
    and the loss is the global mean on every rank. ``zero1`` cuts the
    optimizer state over dp (``AdamW``); at dp 1 and without a mesh it is
    a no-op, as in JAX. ``mesh=None`` is the single-device step."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    device = as_device(device)
    view = None if mesh is None else _mesh_view(mesh, cfg, device)
    plan = None
    if view is not None and zero1 and view.dp_size > 1:
        plan = Zero1(full_param_shardings(mesh, cfg), view.dp,
                     view.dp_rank, view.dp_size)
    optimizer = AdamW(
        learning_rate, ema_decay=ema_decay, master_weights=master_weights,
        zero1=plan,
    )

    def one(params, tokens):
        if view is None:
            loss, grads = loss_and_grads(params, tokens, cfg, device)
            return loss, _leaves(grads)
        return _local_loss_and_grads(params, tokens, cfg, device, view)

    def grads_of(params, tokens):
        """``one`` writes a ``train.forward`` and a ``train.backward``
        span a micro-batch; ``train.reduce`` spans hold the f32 sum over
        micro-batches, their mean, the all-reduce and the cast back."""
        if accum_steps == 1:
            loss, grads = one(params, tokens)
            if view is None:
                return loss, _like(params, grads)
            sp = SPANS.open("train.reduce")
        else:
            if tokens.dim() != 3 or tokens.shape[0] != accum_steps:
                raise ValueError(
                    f"tokens {tuple(tokens.shape)}: want [{accum_steps}, "
                    "batch, seq+1] with accum_steps > 1"
                )
            gsum, lsum = None, None
            for micro in tokens:
                loss, grads = one(params, micro)
                sp = SPANS.open("train.reduce")
                g32 = [g.float() for g in grads]
                if gsum is None:
                    gsum, lsum = g32, loss
                else:
                    torch._foreach_add_(gsum, g32)
                    lsum = lsum + loss
                SPANS.close(sp)
            sp = SPANS.open("train.reduce")
            torch._foreach_div_(gsum, accum_steps)
            loss, grads = lsum / accum_steps, gsum
        if view is not None:   # the global mean's loss and gradients
            loss = loss.reshape(1)
            all_reduce_([loss, *grads], (view.dp, view.sp))
            loss = loss[0]
        if accum_steps > 1 and not master_weights:
            grads = [g.to(p.dtype) for g, p in zip(grads, _leaves(params))]
        SPANS.close(sp)
        return loss, _like(params, grads)

    def train_step(params, opt_state, tokens):
        step = SPANS.open("train.step")
        tokens = torch.as_tensor(tokens, device=device).long()
        loss, grads = grads_of(params, tokens)
        sp = SPANS.open("train.optimizer")
        optimizer.update_(grads, opt_state, params)
        SPANS.close(sp)
        SPANS.close(step)
        return params, opt_state, loss

    def init_all(generator: torch.Generator):
        stored = cfg.dtype if master_weights else torch.float32
        params = init_params(cfg, generator, device, dtype=stored)
        if mesh is not None:
            params = shard_params(params, mesh, cfg)
        return params, optimizer.init(params)

    return train_step, init_all, optimizer


def make_eval_fn(cfg: ModelConfig, device="cuda", mesh=None):
    """(params, tokens [b, seq+1]) -> mean next-token NLL (f32 0-dim
    tensor), with no MoE aux term and no graph. With ``mesh``, as the
    train step: every rank passes the global tokens and its param shards
    and gets the global mean (the vocab-parallel NLL)."""
    device = as_device(device)
    view = None if mesh is None else _mesh_view(mesh, cfg, device)

    @torch.no_grad()
    def eval_loss(params, tokens):
        tokens = torch.as_tensor(tokens, device=device).long()
        if view is None:
            logits, _ = forward_with_aux(params, tokens[:, :-1], cfg, device)
            return _nll(logits, tokens[:, 1:])
        inputs, targets, off, count = _local_chunk(tokens, view)
        logits, _ = _forward(params, inputs, cfg, device, view, off)
        loss = (vocab_parallel_nll_sum(logits, targets, view) / count)
        loss = loss.reshape(1)
        all_reduce_([loss], (view.dp, view.sp))
        return loss[0]

    return eval_loss
