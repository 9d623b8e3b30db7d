"""Multi-device layout for the PyTorch port: the mesh, the parameter split
specs and the collectives of the sharded train step.

Counterpart of the mesh half of ``elastic_tpu_agent/workloads/
transformer.py`` (``make_mesh``, ``param_shardings``,
``_full_param_shardings``, the ``zero1_shard`` rule of ``make_train_step``)
and of what GSPMD inserts there.

**Process model.** The JAX package is a single controller over every
device: arrays are global, ``NamedSharding`` says where their pieces live
and XLA's partitioner writes the collectives. The port runs SPMD: one
process (rank) per device, each holding its **local shards** of the
params, the gradients and the optimizer state, and the collectives are
written out, autograd-aware, on the mesh's process groups. The rank count
is the default process group's world size: ``make_mesh`` needs
``torch.distributed.init_process_group`` first, and ``n_devices`` must
equal the world size. CUDA meshes need the ``nccl`` backend (one card per
rank: NCCL refuses two ranks on one card), CPU meshes ``gloo``; a
mismatch raises rather than falling back.

**Split specs.** ``param_shardings`` gives each leaf a tuple of mesh axis
names (or None), one per tensor axis, as the JAX ``PartitionSpec``s: an
axis named ``"tp"`` is split over the tensor-parallel ranks, an empty
tuple is replicated. ``shard_params`` cuts a rank's slice from a full
tree (the weight bridge converts the JAX tree whole, so the same JAX
weights feed both packages on any mesh); ``gather_params`` rebuilds the
full tree on every rank. An MoE layer's experts split over "ep" and their
hidden axis over "tp" (JAX ``moe_param_shardings``); an int8 ``{"q",
"s"}`` leaf cuts its scale with the weight's spec, size-1 axes unsplit
(``scale_spec``, as JAX ``decode_shardings``).

**Collectives of the sharded step** (Megatron's conjugate pair):
``copy_to`` is the identity forward with an all-reduce backward, in front
of a column-split projection; ``reduce_from`` is an all-reduce forward
with an identity backward, after a row-split projection and in the
vocab-parallel cross entropy. Every rank of a tensor-parallel group then
holds the same replicated activations and the same gradients of its
replicated leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .quantize import _tree_map, is_quantized
from .ring_attention import ProcessGroupRing

MESH_AXES = ("dp", "sp", "tp", "ep")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def mesh_shape(
    n: int, dp: Optional[int] = None, sp: int = 1, tp: Optional[int] = None,
    ep: int = 1,
) -> Tuple[int, int, int, int]:
    """(dp, sp, tp, ep) for ``n`` devices with JAX ``make_mesh``'s defaults:
    tp = 4 when the rest divides by 4, else 2, else 1; dp the remainder."""
    if tp is None:
        rest = n // (sp * ep)
        tp = 4 if rest % 4 == 0 and rest >= 4 else (2 if rest % 2 == 0 else 1)
    if dp is None:
        dp = n // (tp * sp * ep)
    if dp * sp * tp * ep != n:
        raise AssertionError(f"mesh {dp}x{sp}x{tp}x{ep} != {n} devices")
    return dp, sp, tp, ep


def make_mesh(
    n_devices: Optional[int] = None, dp: Optional[int] = None, sp: int = 1,
    tp: Optional[int] = None, ep: int = 1, device_type: str = "cuda",
):
    """A ``DeviceMesh`` with dims ("dp", "sp", "tp", "ep") over the ranks of
    the default process group, one device per rank (see the module
    docstring). ``n_devices`` defaults to the world size and must equal it;
    the axis sizes default as JAX ``make_mesh``'s do."""
    from torch.distributed.device_mesh import init_device_mesh

    n = check_world(n_devices, device_type, "make_mesh")
    return init_device_mesh(
        device_type, mesh_shape(n, dp, sp, tp, ep), mesh_dim_names=MESH_AXES
    )


def check_world(n_devices: Optional[int], device_type: str, who: str) -> int:
    """The device count of a mesh over the default process group (its
    world size): raises unless the group is up, ``n_devices`` (if given)
    equals its size and its backend suits ``device_type``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{who} runs one rank per device: call "
            "torch.distributed.init_process_group (nccl for cuda, gloo for "
            "cpu) in every rank first"
        )
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"n_devices {n} != world size {world}: the port runs one rank "
            "per device"
        )
    want = _BACKENDS.get(device_type)
    if want is None:
        raise ValueError(f"device_type must be cuda or cpu, not {device_type!r}")
    backend = dist.get_backend()
    if backend != want:
        raise ValueError(
            f"a {device_type} mesh needs the {want} backend; the process "
            f"group runs {backend}"
        )
    return n


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


# -- split specs ------------------------------------------------------------


def param_shardings(mesh, cfg=None) -> Dict:
    """Split specs matching ``init_params`` for ``cfg`` (JAX
    ``param_shardings``): tensor-parallel over "tp", replicated over "dp"
    and "sp"; ``layers`` holds one layer spec for every layer."""
    from .transformer import ModelConfig

    cfg = cfg or ModelConfig()
    layer = {
        "ln1_scale": (),
        "wo": ("tp", None, None),            # heads
        "ln2_scale": (),
        "w1": (None, "tp"),                  # FF hidden
        "w2": ("tp", None),                  # FF hidden
    }
    if cfg.is_gqa:
        layer["wq"] = (None, "tp", None)     # q heads
        layer["wkv"] = (None, None, "tp", None)  # kv heads
    else:
        layer["wqkv"] = (None, None, "tp", None)  # heads
    out = {
        "embed": (None, None),
        "final_norm_scale": (),
        "lm_head": (None, "tp"),             # vocab
        "layers": [layer],
    }
    if cfg.pos == "learned":
        out["pos_embed"] = ()
    return out


def full_param_shardings(mesh, cfg) -> Dict:
    """The specs with one entry per layer (JAX ``_full_param_shardings``):
    an MoE layer's ``moe`` subtree as JAX ``moe_param_shardings``. Raises
    unless tp divides the GQA kv heads."""
    if cfg.is_gqa:
        tp = axis_size(mesh, "tp")
        if cfg.kv_heads % tp:
            raise AssertionError(
                f"GQA kv_heads {cfg.kv_heads} must be divisible by tp={tp} "
                "(wkv shards its kv-head axis over tp); use a smaller tp or "
                "more kv heads"
            )
    base = param_shardings(mesh, cfg)
    dense = base["layers"][0]
    moe = {"wg": (), "w1": ("ep", None, "tp"), "w2": ("ep", "tp", None)}
    layers = [
        {k: v for k, v in dense.items() if k not in ("w1", "w2")}
        | {"moe": moe} if cfg.is_moe_layer(i) else dense
        for i in range(cfg.n_layers)
    ]
    return {**{k: v for k, v in base.items() if k != "layers"},
            "layers": layers}


def _spec_at(specs, path) -> Tuple:
    for p in path:
        specs = specs[p]
    return specs


def _split(spec, ndim) -> List[Tuple[int, str]]:
    """(tensor axis, mesh axis) for every split axis of a leaf."""
    return [(i, a) for i, a in enumerate(tuple(spec)[:ndim]) if a is not None]


def scale_spec(spec, s_shape) -> Tuple:
    """The spec of an int8 leaf's scale ``s`` (JAX ``decode_shardings``):
    the weight's spec with every size-1 (keepdims) axis left unsplit."""
    spec = tuple(spec) + (None,) * (len(s_shape) - len(spec))
    return tuple(None if dim == 1 else ax for dim, ax in zip(s_shape, spec))


def _map_split(fn, tree: Dict, specs: Dict) -> Dict:
    """fn(path, tensor, spec) over every tensor of ``tree``; an int8
    ``{"q", "s"}`` leaf maps its two tensors, the scale with
    ``scale_spec``."""

    def leaf(path, x):
        spec = _spec_at(specs, path)
        if is_quantized(x):
            if is_quantized(spec):      # decode_shardings(params=...)'s
                return {k: fn(path, x[k], spec[k]) for k in ("q", "s")}
            return {"q": fn(path, x["q"], spec),
                    "s": fn(path, x["s"], scale_spec(spec, x["s"].shape))}
        return fn(path, x, spec)

    return _tree_map(leaf, tree)


def shard_params(full_tree: Dict, mesh, cfg, specs: Optional[Dict] = None
                 ) -> Dict:
    """This rank's slice of a full params tree: each split axis cut into
    equal contiguous pieces, the rank's by its mesh coordinate; replicated
    leaves copied whole. ``specs`` defaults to ``full_param_shardings``
    (``generate.decode_shardings`` gives the decode ones)."""
    specs = specs or full_param_shardings(mesh, cfg)

    def cut(path, x, spec):
        for axis, name in _split(spec, x.dim()):
            parts = axis_size(mesh, name)
            if x.shape[axis] % parts:
                raise ValueError(
                    f"{'/'.join(map(str, path))}: axis {axis} of size "
                    f"{x.shape[axis]} does not split over {name}={parts}"
                )
            size = x.shape[axis] // parts
            x = x.narrow(axis, mesh.get_local_rank(name) * size, size)
        return x.detach().clone()

    return _map_split(cut, full_tree, specs)


def gather_params(local_tree: Dict, mesh, cfg, specs: Optional[Dict] = None
                  ) -> Dict:
    """The full tree on every rank from each rank's ``shard_params``
    slice (an all-gather over each split axis's group)."""
    specs = specs or full_param_shardings(mesh, cfg)

    def whole(path, x, spec):
        for axis, name in _split(spec, x.dim()):
            x = _gather_axis(x, axis, mesh.get_group(name))
        return x.detach().clone()

    return _map_split(whole, local_tree, specs)


def _gather_axis(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``axis``, in group
    rank order."""
    x = x.detach().contiguous()
    if dist.get_world_size(group) == 1:
        return x
    pieces = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(pieces, x, group=group)
    return torch.cat(pieces, dim=axis)


# -- autograd-aware collectives ----------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-split projection: the same tensor on every
    rank of ``group``, whose gradient is the sum of the ranks' gradients."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' partial results (a row-split projection's
    output), replicated over ``group``; each rank's gradient is the
    replicated one."""
    return _ReduceFrom.apply(x, group)


@dataclasses.dataclass
class LocalView:
    """One rank's place in the mesh, as the sharded forward reads it."""

    dp: Any
    sp: Any
    tp: Any
    dp_rank: int
    dp_size: int
    sp_rank: int
    sp_size: int
    tp_rank: int
    tp_size: int
    ring: Any
    ep: Any = None
    ep_rank: int = 0
    ep_size: int = 1


def local_view(mesh) -> LocalView:
    def axis(name):
        return (mesh.get_group(name), mesh.get_local_rank(name),
                axis_size(mesh, name))

    (dp, dpr, dps), (sp, spr, sps), (tp, tpr, tps), (ep, epr, eps) = map(
        axis, ("dp", "sp", "tp", "ep"))
    return LocalView(dp, sp, tp, dpr, dps, spr, sps, tpr, tps,
                     ProcessGroupRing(sp), ep, epr, eps)


def vocab_parallel_nll_sum(
    logits: torch.Tensor, targets: torch.Tensor, view: LocalView,
) -> torch.Tensor:
    """Sum over the local tokens of the next-token cross entropy, f32, with
    ``logits`` [b, s, vocab/tp] this rank's vocabulary slice of
    ``lm_head``'s tp split: the max and the sum of exponentials are
    all-reduced over tp, and the target logit comes from the rank that
    owns it. At tp 1 it is ``F.cross_entropy``'s sum, which the
    single-device step's mean divides."""
    z = logits.float()
    if view.tp_size == 1:
        return F.cross_entropy(
            z.flatten(0, 1), targets.flatten(), reduction="sum")
    width = z.shape[-1]
    m = z.detach().amax(-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=view.tp)
    sumexp = reduce_from(torch.exp(z - m).sum(-1), view.tp)
    local = targets - view.tp_rank * width
    mine = (local >= 0) & (local < width)
    picked = z.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
    target = reduce_from(torch.where(mine, picked, 0.0), view.tp)
    return (torch.log(sumexp) + m[..., 0] - target).sum()


def all_reduce_(tensors: Sequence[torch.Tensor], groups) -> None:
    """Sum each tensor over every group in ``groups``, in place, one flat
    buffer per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        for g in groups:
            dist.all_reduce(flat, group=g)
        torch._foreach_copy_(
            ts, [p.view_as(t) for p, t in zip(
                flat.split([t.numel() for t in ts]), ts)])


# -- ZeRO-1 -------------------------------------------------------------------


def zero1_axis(spec, shape, dp_size: int) -> Optional[int]:
    """JAX ``zero1_shard``: the first axis the param's spec leaves
    unsharded and that ``dp_size`` divides (None: the leaf keeps its
    param's sharding)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % dp_size == 0 and dim >= dp_size:
            return i
    return None


class Zero1:
    """The optimizer-state split of ZeRO-1 over the dp group. ``axes``
    gives each leaf of a params tree (in its leaf order) the axis its
    state is cut along, or None; ``part`` narrows a full local leaf to
    this dp rank's slice (a view); ``gather_`` writes every dp rank's
    fresh slices into the full leaves."""

    def __init__(self, specs: Dict, group, rank: int, size: int):
        self.specs, self.group = specs, group
        self.rank, self.size = rank, size

    def axes(self, tree) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        _tree_map(lambda path, x: out.append(zero1_axis(
            _spec_at(self.specs, path), x.shape, self.size)), tree)
        return out

    def part(self, axis: Optional[int], x: torch.Tensor) -> torch.Tensor:
        if axis is None:
            return x
        n = x.shape[axis] // self.size
        return x.narrow(axis, self.rank * n, n)

    @torch.no_grad()
    def gather_(self, fulls: Sequence[torch.Tensor],
                slices: Sequence[torch.Tensor],
                axes: Sequence[Optional[int]]) -> None:
        """fulls[i] <- the dp ranks' slices[i] along axes[i], for the leaves
        that are cut (one all-gather of a flat buffer per dtype)."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, a in enumerate(axes):
            if a is not None:
                by_dtype.setdefault(fulls[i].dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            flat = torch.cat([slices[i].to(dtype).reshape(-1) for i in idx])
            out = torch.empty(self.size * flat.numel(), dtype=dtype,
                              device=flat.device)
            dist.all_gather_into_tensor(out, flat, group=self.group)
            out = out.view(self.size, -1)
            off = 0
            for i in idx:
                shape, n = slices[i].shape, slices[i].numel()
                pieces = [out[r, off:off + n].view(shape)
                          for r in range(self.size)]
                fulls[i].copy_(torch.cat(pieces, dim=axes[i]))
                off += n
