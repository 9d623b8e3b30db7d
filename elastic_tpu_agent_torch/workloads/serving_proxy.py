"""Analytic device-memory traffic / FLOPs model of the serving decode step,
PyTorch port, and the rule that resolves ``ServingEngine(paged_kernel=None)``.

Counterpart of ``elastic_tpu_agent/workloads/serving_proxy.py``. Per decode
step, over the KV cache (parameter reads are the same on both paths and
reported apart):

- the gather path gathers the live slots' blocks into a dense
  [slots, S] view, attends against it and writes the one new position
  back: the pool blocks are read once to build the view, the view is
  written and read again by attention (3x the view's bytes), plus the
  one-position write-back;
- the paged path (``paged_attention.paged_decode_attention``) streams each
  attended block once (1x), plus the same write-back.

Both compute over the same bucket-padded width, so FLOPs are equal and the
KV-byte ratio sits just under 3. The paged term is one full sweep of the
live view as the port's own ``paged_attention.kernel_traffic`` counts it
(every table entry full, no window), which is JAX's formula for it; so
``decode_step_traffic`` returns JAX's dict key for key and value for value.

The threshold: ``paged_kernel=None`` resolves on when the kernel runs
natively (a CUDA device, a float pool, no tensor-parallel mesh) and the
modeled gather/paged KV-byte ratio at the engine's own shape is at least
``PAGED_DEFAULT_MIN_RATIO``. On CPU tensors the wrapper runs the kernel's
plain version, which has no device memory to save, so the rule resolves
off there; an explicit ``paged_kernel=True/False`` always wins.

``serving_proxy_report`` carries JAX's keys. JAX's ``xla_cost_analysis``
corroboration compiles both attention programs with XLA; the port has no
XLA, so the key holds an error, as JAX's own ``except`` branch fills it.
One key is the port's own: ``hopper_split_k``, the Hopper kernel's
split-K traffic at the operating point.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .paged_attention import kernel_traffic, paged_splits

# The paged default goes on (native only) at this modeled gather/paged
# KV-byte ratio; the model puts it at ~3 for every realistic shape, so 1.5
# leaves a 2x margin for traffic the model cannot see.
PAGED_DEFAULT_MIN_RATIO = 1.5

# Reference operating point when the engine's own shape is not in hand.
DEFAULT_SLOTS = 8
DEFAULT_SEQ_LEN = 512
DEFAULT_BLOCK_SIZE = 32


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    """``bfloat16``/``float32``, as ``str(np.dtype(...))`` reads in JAX."""
    return str(dtype).removeprefix("torch.")


def _matmul_param_count(cfg) -> int:
    """Parameters decode re-reads per step (every matmul weight; the
    embedding gather reads one row per token and is excluded)."""
    n, g, h = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    d, f = cfg.d_model, cfg.d_ff
    per_layer = n * h * d                       # wo
    if cfg.is_gqa:
        per_layer += d * n * h + d * 2 * g * h  # wq + wkv
    else:
        per_layer += d * 3 * n * h              # wqkv
    per_layer += d * f + f * d                  # w1 + w2
    return cfg.n_layers * per_layer + d * cfg.vocab  # + lm_head


def _view_blocks(seq_len: int, block_size: int,
                 max_len: Optional[int]) -> int:
    """The engine's gather width in blocks at depth ``seq_len``."""
    # the engine's own bucketing, imported here: serving imports this
    # module
    from .serving import gather_bucket

    max_blocks = -(-(max_len or max(seq_len, 1)) // block_size)
    return gather_bucket(-(-seq_len // block_size), max_blocks)


def decode_step_traffic(
    cfg,
    slots: int = DEFAULT_SLOTS,
    seq_len: int = DEFAULT_SEQ_LEN,
    block_size: int = DEFAULT_BLOCK_SIZE,
    kv_int8: bool = False,
    max_len: Optional[int] = None,
) -> Dict:
    """Modeled bytes moved and FLOPs for ONE decode step over ``slots``
    live rows at depth ``seq_len``, for both step paths (JAX's dict)."""
    g, h, L = cfg.kv_heads, cfg.head_dim, cfg.n_layers
    n = cfg.n_heads
    itemsize = _itemsize(cfg.dtype)
    nb = _view_blocks(seq_len, block_size, max_len)
    S = nb * block_size                     # bucket-padded view width
    # K+V bytes per cached position, as stored in the pool
    if kv_int8:
        per_pos = 2 * g * (h * 1 + 4)       # int8 entries + f32 scale
    else:
        per_pos = 2 * g * h * itemsize
    # one full sweep of the live view from the kernel's own accounting
    # (per layer; scaled by the pool's storage ratio for int8)
    kt = kernel_traffic(slots, nb, block_size, g, h, itemsize)
    view_bytes = (
        L * kt["kv_bytes_read"] * per_pos // (2 * g * h * itemsize)
    )
    writeback = L * slots * per_pos         # the one written position
    # FLOPs are path-independent: q.K and p.V over the padded width
    # (2 FLOPs per MAC), plus every matmul weight once per slot-token
    attn_flops = L * slots * 2 * (2 * n * h * S)
    param_flops = 2 * _matmul_param_count(cfg) * slots
    param_bytes = _matmul_param_count(cfg) * itemsize
    gather_kv = 3 * view_bytes + writeback
    paged_kv = view_bytes + writeback
    return {
        "slots": slots,
        "seq_len": seq_len,
        "block_size": block_size,
        "gather_blocks": nb,
        "kv_int8": kv_int8,
        "gather": {
            "kv_bytes": gather_kv,
            "total_bytes": gather_kv + param_bytes,
            "flops": attn_flops + param_flops,
        },
        "paged": {
            "kv_bytes": paged_kv,
            "total_bytes": paged_kv + param_bytes,
            "flops": attn_flops + param_flops,
        },
        "param_bytes": param_bytes,
        "kv_bytes_ratio": round(gather_kv / paged_kv, 3),
        "total_bytes_ratio": round(
            (gather_kv + param_bytes) / (paged_kv + param_bytes), 3
        ),
        "ops_ratio": 1.0,  # same masked compute on both paths
    }


def recommend_paged_kernel(
    cfg=None,
    interpret: bool = False,
    kv_int8: bool = False,
    mesh=None,
    slots: int = DEFAULT_SLOTS,
    seq_len: int = DEFAULT_SEQ_LEN,
    block_size: int = DEFAULT_BLOCK_SIZE,
) -> bool:
    """``ServingEngine(paged_kernel=None)``'s resolution (module
    docstring). ``interpret`` is True where the kernel would run its plain
    version (CPU tensors)."""
    if interpret or kv_int8 or mesh is not None:
        return False
    if cfg is None:
        return True  # the ratio is shape-independent at ~3x
    est = decode_step_traffic(
        cfg, slots=slots, seq_len=seq_len, block_size=block_size
    )
    return est["kv_bytes_ratio"] >= PAGED_DEFAULT_MIN_RATIO


def hopper_split_k(cfg, slots: int = DEFAULT_SLOTS,
                   seq_len: int = DEFAULT_SEQ_LEN,
                   block_size: int = DEFAULT_BLOCK_SIZE) -> Dict:
    """One paged-kernel call's traffic at the operating point (one layer;
    a decode step makes ``n_layers`` calls), every table entry full: the
    split count the H100 policy picks, the bytes the function needs, the
    split-K partials' write and read-back, and all the launch moves."""
    nb = _view_blocks(seq_len, block_size, None)
    splits = paged_splits(slots, cfg.kv_heads, nb)
    kt = kernel_traffic(slots, nb, block_size, cfg.kv_heads, cfg.head_dim,
                        _itemsize(cfg.dtype), n_heads=cfg.n_heads,
                        splits=splits)
    return {"splits": splits, "calls_per_step": cfg.n_layers,
            **{k: kt[k] for k in ("bytes", "partial_bytes",
                                  "kernel_bytes")}}


def serving_proxy_report(cfg=None) -> Dict:
    """JAX's ``serving_proxy`` payload: modeled traffic at the reference
    operating point (float and int8 pools), the threshold and the
    resulting default, plus ``hopper_split_k``. Deterministic."""
    if cfg is None:
        from .transformer import ModelConfig

        # the JAX bench flagship's shape
        cfg = ModelConfig(
            vocab=32768, d_model=2048, n_heads=16, n_layers=8,
            d_ff=8192, max_seq=1024,
        )
    model = decode_step_traffic(cfg)
    model_int8 = decode_step_traffic(cfg, kv_int8=True)
    return {
        "operating_point": {
            "model": {
                "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                "n_heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
                "head_dim": cfg.head_dim, "dtype": _dtype_name(cfg.dtype),
            },
            "slots": model["slots"],
            "seq_len": model["seq_len"],
            "block_size": model["block_size"],
        },
        "per_decode_step": {
            "gather": model["gather"],
            "paged": model["paged"],
            "param_bytes": model["param_bytes"],
        },
        "hbm_kv_bytes_ratio_gather_over_paged": model["kv_bytes_ratio"],
        "hbm_total_bytes_ratio": model["total_bytes_ratio"],
        "ops_ratio": model["ops_ratio"],
        "int8_kv": {
            "paged_kv_bytes": model_int8["paged"]["kv_bytes"],
            "kv_bytes_reduction_vs_float": round(
                model["paged"]["kv_bytes"]
                / model_int8["paged"]["kv_bytes"], 3
            ),
        },
        "threshold": PAGED_DEFAULT_MIN_RATIO,
        "paged_kernel_default": {
            # JAX's key names: "tpu_native" is the native kernel (here a
            # CUDA device), "cpu_interpret" its plain version on the CPU
            "tpu_native": recommend_paged_kernel(cfg, interpret=False),
            "cpu_interpret": recommend_paged_kernel(cfg, interpret=True),
            "rule": (
                "paged_kernel=None resolves ON iff the kernel runs "
                "natively (CUDA device, float pool, no mesh) AND the "
                "modeled gather/paged KV-byte ratio >= threshold"
            ),
        },
        "xla_cost_analysis": {
            "error": (
                "NotImplementedError: XLA's compiled cost analysis has no "
                "counterpart in the PyTorch port (no XLA programs); the "
                "analytic model is the decision input"
            ),
        },
        "hopper_split_k": hopper_split_k(cfg),
    }
