"""Serving partitioner, PyTorch port: the ("dp", "mp") serving mesh and the
tensor-parallel ServingEngine's split rules.

Counterpart of ``elastic_tpu_agent/workloads/partitioner.py``. The layout
is JAX's:

- attention heads (wq/wqkv, wo) and GQA kv heads (wkv) split over "mp";
- the MLP hidden axis (w1/w2) and the lm_head vocab axis split over "mp"
  (an all-reduce after wo and w2, the Megatron shape);
- the paged KV pool [L, n_blocks, bs, kv_heads, h] splits its kv-head
  axis over "mp", so the pool bookkeeping (allocator, tables, refcounts)
  is the single-device engine's and occupancy matches it block for block;
- embeddings and norms replicate, and "dp" is a fleet-of-engines axis:
  one engine owns one continuous batch, which is not split.

**Process model.** JAX's engine is one controller over every device. The
port runs SPMD (``parallel.py``): one rank per device, every rank running
the same engine with the same requests, holding its "mp" shards of the
params and its kv heads of the pool. The host state (allocator, tables,
refcounts, prefix cache, sampling generator) is the same on every rank,
and the logits are gathered over "mp" before sampling, so every rank
draws the same tokens. dp ranks compute the same streams.

Split specs are tuples of mesh axis names (or None), one per tensor axis,
as JAX's ``PartitionSpec``s; ``()`` replicates.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .parallel import (
    LocalView,
    axis_size,
    check_world,
    scale_spec,
    shard_params as _shard_params,
)
from .quantize import is_quantized

# Logical-axis -> mesh-axis rules (JAX's RULES)
RULES = {
    "batch": None,
    "heads": "mp",
    "embed": None,
    "mlp": "mp",
    "kv_heads": "mp",
    "seq": None,
    "vocab": "mp",
}

# Per-leaf specs against init_params' shapes: wqkv [d, 3, n, h],
# wq [d, n, h], wkv [d, 2, g, h], wo [n, h, d], w1 [d, f], w2 [f, d],
# lm_head [d, v]. Everything absent here replicates.
_LEAF_SPECS = {
    "wqkv": (None, None, RULES["heads"], None),
    "wq": (None, RULES["heads"], None),
    "wkv": (None, None, RULES["kv_heads"], None),
    "wo": (RULES["heads"], None, None),
    "w1": (None, RULES["mlp"]),
    "w2": (RULES["mlp"], None),
    "lm_head": (None, RULES["vocab"]),
}

# The paged pool [L, n_blocks, block, kv_heads, head_dim]: kv heads over
# "mp" (the block axis is addressed by host-side tables; splitting it
# would shard the allocator too)
POOL_SPEC = (None, None, None, RULES["kv_heads"], None)
_POOL_HEAD_AXIS = POOL_SPEC.index("mp")

SERVING_AXES = ("dp", "mp")


def make_serving_mesh(
    mp: Optional[int] = None, n_devices: Optional[int] = None,
    device_type: str = "cuda",
):
    """A ``DeviceMesh`` with dims ("dp", "mp") over the ranks of the
    default process group, one device per rank (``parallel.make_mesh``'s
    process model and checks: ``n_devices`` must equal the world size);
    default mp = all of them (one tensor-parallel engine spanning the
    world)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = check_world(n_devices, device_type, "make_serving_mesh")
    if mp is None:
        mp = n
    if n % mp:
        raise ValueError(f"mp={mp} does not divide {n} devices")
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=SERVING_AXES)


class ServingPartitioner:
    """Owns the serving engine's mesh and split rules (JAX's
    ``ServingPartitioner``). ``mesh=None`` is the single-device
    partitioner: every method is a passthrough, so the engine has one
    code path."""

    def __init__(self, mesh, cfg) -> None:
        self.mesh = mesh
        self.cfg = cfg
        if mesh is None:
            return
        if "mp" not in (getattr(mesh, "mesh_dim_names", None) or ()):
            raise ValueError(
                "serving mesh needs an 'mp' axis; build it with "
                "partitioner.make_serving_mesh"
            )
        if cfg.moe_experts:
            raise ValueError(
                "tensor-parallel serving supports dense models (MoE "
                "expert parallelism is a different mesh axis)"
            )
        mp = self.mp
        for name, dim in (
            ("n_heads", cfg.n_heads),
            ("kv_heads", cfg.kv_heads),
            ("d_ff", cfg.d_ff),
            ("vocab", cfg.vocab),
        ):
            if dim % mp:
                raise ValueError(
                    f"cfg.{name} {dim} must divide over mp={mp} "
                    "(heads/mlp/vocab all split on that axis)"
                )

    @property
    def mp(self) -> int:
        return 1 if self.mesh is None else axis_size(self.mesh, "mp")

    def view(self) -> Optional[LocalView]:
        """This rank's place for ``generate._forward_chunk(view=)``: the
        mesh's "mp" group as the tensor-parallel group, no sequence or
        expert split (None without a mesh)."""
        if self.mesh is None:
            return None
        m = self.mesh
        return LocalView(
            dp=m.get_group("dp"), sp=None, tp=m.get_group("mp"),
            dp_rank=m.get_local_rank("dp"), dp_size=axis_size(m, "dp"),
            sp_rank=0, sp_size=1, tp_rank=m.get_local_rank("mp"),
            tp_size=self.mp, ring=None,
        )

    # -- params -------------------------------------------------------

    @staticmethod
    def _leaf_spec(name: str, leaf):
        spec = _LEAF_SPECS.get(name, ())
        if is_quantized(leaf):
            # int8 weight-only leaf: the scale keeps its keepdims (size-1)
            # axes unsplit (generate.decode_shardings' rule)
            return {"q": spec, "s": scale_spec(spec, leaf["s"].shape)}
        return spec

    def param_shardings(self, params: Dict) -> Dict:
        """Split-spec tree matching ``params`` leaf for leaf (JAX's
        ``PartitionSpec`` tuples; ``()`` replicates)."""
        out = {
            name: self._leaf_spec(name, leaf)
            for name, leaf in params.items()
            if name != "layers"
        }
        out["layers"] = [
            {name: self._leaf_spec(name, leaf)
             for name, leaf in layer.items()}
            for layer in params["layers"]
        ]
        return out

    def shard_params(self, params: Dict) -> Dict:
        """This rank's cut of a full params tree (every rank passes the
        whole tree)."""
        if self.mesh is None:
            return params
        return _shard_params(params, self.mesh, self.cfg,
                             self.param_shardings(params))

    # -- the paged KV pool --------------------------------------------

    def pool_sharding(self):
        return None if self.mesh is None else POOL_SPEC

    def local_kv_heads(self) -> int:
        """The kv heads of this rank's pool."""
        return self.cfg.kv_heads // self.mp

    def place_pool(self, pool):
        """This rank's kv heads of a full pool side (a tensor, or the int8
        {"q", "s"} pair: the scale's trailing size-1 axis replicates under
        the same spec)."""
        if self.mesh is None:
            return pool
        rank, g = self.mesh.get_local_rank("mp"), self.local_kv_heads()

        def cut(t: torch.Tensor) -> torch.Tensor:
            return t.narrow(_POOL_HEAD_AXIS, rank * g, g).clone()

        if isinstance(pool, dict):
            return {"q": cut(pool["q"]), "s": cut(pool["s"])}
        return cut(pool)
