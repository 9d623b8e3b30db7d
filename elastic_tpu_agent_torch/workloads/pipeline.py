"""Pipeline parallelism, PyTorch port: GPipe microbatching over a "pp"
axis.

Counterpart of ``elastic_tpu_agent/workloads/pipeline.py``, with JAX's
tick schedule: ``m + pp - 1`` ticks; at tick t stage p runs microbatch
``t - p`` (stage 0 ingests microbatch t, the last stage finishes
``t - (pp - 1)``) and hands its activation to stage p + 1. The result is
the last stage's outputs in microbatch order, on every pp rank (JAX's
masked ``psum``). Stage weights are stacked with a leading [pp] axis.

**Transports**, as ``ring_attention.py`` has a ring over a process group
and a stacked one:

- ``ProcessGroupPipe`` (the real path): one stage per rank of the mesh's
  pp group (``make_pipeline_mesh``), holding its own stage's leaves
  ([1, ...], ``shard_stages``) and its dp slice of the microbatches. A
  tick's hand-off is one ``dist.batch_isend_irecv`` to the next and from
  the previous stage. For GPipe it sits in a ``torch.autograd.Function``
  whose backward sends the cotangent the other way, as JAX's ``ppermute``
  transposes; a scalar token threads every hand-off and the final
  broadcast, so that each rank's backward runs its hand-offs one tick at a
  time in reverse order, paired with its neighbours' (run it with
  ``torch.autograd.backward``, which runs every node: ``autograd.grad``
  would prune the hand-offs that lead to no requested leaf).
- ``StackedPipe``: every stage in one process, in the same tick order; a
  hand-off passes the tensor on. The path on one card and in the
  in-process tests.

A rank skips its bubble ticks: they compute only values that JAX masks
out, so the numbers are the same, and a hand-off happens exactly when its
receiver has a microbatch to run, so every send meets its receive.
``make_pipeline_train_step`` is JAX's regression step over stacked
residual gelu blocks (``stage_block``), with ``optax.adam`` as
``AdamW(weight_decay=0.0)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .parallel import _gather_axis, all_reduce_, check_world
from .quantize import _tree_map

PIPE_AXES = ("pp", "dp")


def make_pipeline_mesh(pp: int, dp: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` with dims ("pp", "dp") over the ranks of the
    default process group, one device per rank (``parallel.make_mesh``'s
    process model and checks)."""
    from torch.distributed.device_mesh import init_device_mesh

    check_world(pp * dp, device_type, "make_pipeline_mesh")
    return init_device_mesh(device_type, (pp, dp), mesh_dim_names=PIPE_AXES)


class StackedPipe:
    """All ``size`` stages in one process: stage leaves [pp, ...], the
    whole batch of each microbatch."""

    def __init__(self, size: int):
        self.size = size
        self.indices = tuple(range(size))
        self.dp_size, self.dp_rank = 1, 0

    def shift(self, token, sends: Dict[int, torch.Tensor], need, like):
        """The differentiable hand-off: stage p + 1 gets stage p's tensor."""
        return token, {p + 1: y for p, y in sends.items()}

    def exchange(self, fwd, bwd, need_fwd, need_bwd, like):
        """The 1F1B hand-off: activations to the next stage, cotangents to
        the previous one."""
        return ({p + 1: y for p, y in fwd.items()},
                {p - 1: g for p, g in bwd.items()})

    def collect(self, outs: List[torch.Tensor], token, like) -> torch.Tensor:
        return torch.stack(outs)

    def sum_over_pp(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: each tensor summed over the pp ranks (one holds it)."""

    def mean_over_dp(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: each tensor averaged over the dp ranks."""


class ProcessGroupPipe:
    """Stage ``rank`` of the pp group in this process; ``dp`` the group of
    the ranks that hold the same stage for other microbatch rows."""

    def __init__(self, group, dp_group=None):
        self.group, self.dp = group, dp_group
        self.size = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.indices = (rank,)
        self._next = (dist.get_global_rank(group, rank + 1)
                      if rank + 1 < self.size else None)
        self._prev = (dist.get_global_rank(group, rank - 1)
                      if rank > 0 else None)
        self.dp_size = dist.get_world_size(dp_group) if dp_group else 1
        self.dp_rank = dist.get_rank(dp_group) if dp_group else 0

    def _p2p(self, send_next, send_prev, recv_prev: bool, recv_next: bool,
             like) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One batch of this tick's sends and receives: (the tensor from
        the previous stage, the one from the next)."""
        ops, got_prev, got_next = [], None, None
        if send_next is not None:
            ops.append(dist.P2POp(dist.isend, send_next.contiguous(),
                                  self._next, self.group, 0))
        if recv_prev:
            got_prev = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got_prev, self._prev,
                                  self.group, 0))
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, send_prev.contiguous(),
                                  self._prev, self.group, 1))
        if recv_next:
            got_next = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got_next, self._next,
                                  self.group, 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got_prev, got_next

    def shift(self, token, sends, need, like):
        p = self.indices[0]
        if p not in sends and p not in need:
            return token, {}
        token, got = _Shift.apply(token, sends.get(p), self, p in need,
                                  like)
        return token, ({p: got} if p in need else {})

    def exchange(self, fwd, bwd, need_fwd, need_bwd, like):
        p = self.indices[0]
        got_prev, got_next = self._p2p(fwd.get(p), bwd.get(p),
                                       p in need_fwd, p in need_bwd, like)
        return ({p: got_prev} if got_prev is not None else {},
                {p: got_next} if got_next is not None else {})

    def collect(self, outs, token, like) -> torch.Tensor:
        mine = (torch.stack(outs) if outs[0] is not None
                else torch.zeros((len(outs), *like.shape), dtype=like.dtype,
                                 device=like.device))
        return _Broadcast.apply(mine, token, self.group)

    def sum_over_pp(self, tensors) -> None:
        all_reduce_(tensors, (self.group,))

    def mean_over_dp(self, tensors) -> None:
        if self.dp_size > 1:
            all_reduce_(tensors, (self.dp,))
            torch._foreach_div_(list(tensors), float(self.dp_size))


Pipe = Union[StackedPipe, ProcessGroupPipe]


class _Shift(torch.autograd.Function):
    """A GPipe hand-off: y to the next stage, the previous stage's tensor
    back (JAX's ``ppermute``); the backward sends the received tensor's
    cotangent to the previous stage and receives y's from the next."""

    @staticmethod
    def forward(ctx, token, y, pipe, recv, like):
        got, _ = pipe._p2p(y, None, recv, False, like)
        ctx.pipe, ctx.sent, ctx.recv, ctx.like = pipe, y is not None, recv, like
        ctx.set_materialize_grads(False)
        out = got if recv else like.new_empty(0)
        return token.clone(), out

    @staticmethod
    def backward(ctx, dtoken, dgot):
        if ctx.recv and dgot is None:
            dgot = torch.zeros_like(ctx.like)
        _, dy = ctx.pipe._p2p(None, dgot if ctx.recv else None, False,
                              ctx.sent, ctx.like)
        return dtoken, dy, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every pp rank (sum of the ranks'
    masked outputs), with an identity backward: every rank computes the
    same loss from them, and the last stage takes its own copy's
    cotangent. The token carries the backward to the hand-offs."""

    @staticmethod
    def forward(ctx, outs, token, group):
        y = outs.detach().contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, torch.zeros((), dtype=torch.float32, device=dy.device), None


def as_pipe(mesh_or_pipe) -> Pipe:
    """The transport for a ("pp", "dp") mesh, or the pipe itself."""
    if hasattr(mesh_or_pipe, "mesh_dim_names"):
        return ProcessGroupPipe(mesh_or_pipe.get_group("pp"),
                                mesh_or_pipe.get_group("dp"))
    return mesh_or_pipe


def stage_of(stage_params: Dict, j: int) -> Dict:
    """The leaves of the j-th stage this process holds."""
    return _tree_map(lambda path, a: a[j], stage_params)


def shard_stages(stacked: Dict, mesh_or_pipe) -> Dict:
    """This process's stages of [pp, ...] leaves: all of them on a
    ``StackedPipe``, its own ([1, ...]) on a ``ProcessGroupPipe``."""
    pipe = as_pipe(mesh_or_pipe)
    lo, n = pipe.indices[0], len(pipe.indices)
    return _tree_map(lambda path, a: a[lo:lo + n].detach().clone(), stacked)


def gather_stages(local: Dict, mesh_or_pipe) -> Dict:
    """The [pp, ...] leaves on every rank from each rank's stages."""
    pipe = as_pipe(mesh_or_pipe)
    if isinstance(pipe, StackedPipe):
        return _tree_map(lambda path, a: a.detach().clone(), local)
    return _tree_map(lambda path, a: _gather_axis(a, 0, pipe.group), local)


def dp_rows(x: torch.Tensor, pipe: Pipe) -> torch.Tensor:
    """This rank's dp slice of a global [m, batch, ...] tensor."""
    if x.shape[1] % pipe.dp_size:
        raise ValueError(f"batch {x.shape[1]} does not split over "
                         f"dp={pipe.dp_size}")
    n = x.shape[1] // pipe.dp_size
    return x.narrow(1, pipe.dp_rank * n, n)


def pipeline_apply(
    mesh_or_pipe, stage_fn: Callable, stage_params: Dict,
    microbatches: torch.Tensor,
) -> torch.Tensor:
    """Run ``stage_fn(stage_leaves, x)`` as a pp-deep pipeline (GPipe).

    stage_params: leaves with a leading stage axis, this process's stages
    (``shard_stages``); microbatches: [m, batch, ...], this rank's dp rows
    on a mesh. Returns [m, batch, ...]: the last stage's outputs, in
    microbatch order, on every pp rank. Differentiable in both (on a
    process-group pipe run the backward with ``torch.autograd.backward``;
    see the module docstring). ``stage_fn`` keeps its input's shape and
    dtype, as JAX's carry does."""
    pipe = as_pipe(mesh_or_pipe)
    pp, m = pipe.size, microbatches.shape[0]
    like = microbatches[0].detach()
    stages = [stage_of(stage_params, j) for j in range(len(pipe.indices))]
    token = torch.zeros((), device=like.device, requires_grad=True)
    inbox: Dict[int, torch.Tensor] = {}
    outs: List[Optional[torch.Tensor]] = [None] * m
    for t in range(m + pp - 1):
        sends = {}
        for j, p in enumerate(pipe.indices):
            i = t - p
            if not 0 <= i < m:
                continue                      # a bubble tick
            y = stage_fn(stages[j], microbatches[i] if p == 0 else inbox[p])
            if p == pp - 1:
                outs[i] = y
            else:
                sends[p] = y
        need = {p for p in pipe.indices if p > 0 and 0 <= t + 1 - p < m}
        token, inbox = pipe.shift(token, sends, need, like)
    return pipe.collect(outs, token, like)


# -- a small pipelined model + train step (the JAX demo/test vehicle) ------


def init_stage_params(generator: torch.Generator, pp: int, d_model: int,
                      d_ff: int, device="cuda") -> Dict:
    """pp stacked residual gelu-MLP blocks, f32 normal(0.02), drawn from
    ``generator`` on the CPU; parity with JAX goes through
    ``weights.stage_params_from_jax``."""

    def draw(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(device)

    return {"w1": draw(pp, d_model, d_ff), "w2": draw(pp, d_ff, d_model)}


def stage_block(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """One stage: residual MLP block in the input dtype (gelu with tanh,
    ``jax.nn.gelu``'s default)."""
    h = F.gelu(x @ params["w1"].to(x.dtype), approximate="tanh")
    return x + h @ params["w2"].to(x.dtype)


def make_pipeline_train_step(
    mesh_or_pipe, d_model: int, d_ff: int, learning_rate: float = 1e-2,
    device="cuda",
):
    """(train_step, init_all), as JAX's: ``train_step(params, opt_state,
    x [m, b, d], y [m, b, d]) -> (params, opt_state, loss)`` regresses
    the pipelined block stack onto y with the mean squared error and
    ``optax.adam``, updating ``params`` and ``opt_state`` in place. Every
    rank passes the global x and y and takes its dp rows; params are its
    stages (``init_all(generator)`` draws the whole stack and cuts them);
    the loss and the gradients are the global batch's."""
    from .transformer import AdamW, _leaves, _like, as_device

    device = as_device(device)
    pipe = as_pipe(mesh_or_pipe)
    optimizer = AdamW(learning_rate, weight_decay=0.0)

    def train_step(params, opt_state, x, y):
        x = dp_rows(torch.as_tensor(x, device=device), pipe)
        y = dp_rows(torch.as_tensor(y, device=device), pipe)
        live = _tree_map(lambda path, a: a.detach().requires_grad_(), params)
        with torch.enable_grad():
            out = pipeline_apply(pipe, stage_block, live, x)
            loss = torch.mean(torch.square(out - y))
            torch.autograd.backward(loss)
        grads = [a.grad if a.grad is not None else torch.zeros_like(a)
                 for a in _leaves(live)]
        loss = loss.detach().reshape(1)
        pipe.mean_over_dp([loss, *grads])
        optimizer.update_(_like(params, grads), opt_state, params)
        return params, opt_state, loss[0]

    def init_all(generator: torch.Generator):
        params = shard_stages(
            init_stage_params(generator, pipe.size, d_model, d_ff, device),
            pipe)
        return params, optimizer.init(params)

    return train_step, init_all
