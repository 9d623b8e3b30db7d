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

``serving_proxy_report`` carries JAX's keys. Its ``xla_cost_analysis``
is ``xla_measured_costs``: JAX reads XLA's compiled cost analysis of the
two attention programs; the port has no XLA and tallies the ops the two
plain programs dispatch instead (its docstring says what is counted). One
key is the port's own: ``hopper_split_k``, the Hopper kernel's split-K
traffic at the operating point.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .paged_attention import (
    PAGED_DECODE,
    _sm_count,
    kernel_traffic,
    paged_decode_attention,
    paged_decode_attention_emulated,
    paged_decode_attention_reference,
    paged_splits,
)

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


class _ByteTally(TorchDispatchMode):
    """Sums, over every dispatched op that is not a view, the bytes of
    its input and output tensors: each op's reads and writes as if every
    operand went through memory once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor)
            )
        return out


# the card sleeps this many clock cycles (~0.1 s) before a timed leg, so
# that the host queues the leg's launches before the card reaches them.
# A kernel library's first launch in a process also starts its own CUDA
# runtime, which outlasted even this on an H100: ``queued`` then reads
# False and the time holds that start.
_SLEEP_CYCLES = 200_000_000


def _event_ms(fn):
    """(fn()'s result, its device ms, whether the host had queued all of it
    before the card started): CUDA events around one call queued behind a
    sleep kernel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    start.record()
    out = fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), queued


def _max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


def xla_measured_costs(
    slots: int = 4, kv_heads: int = 2, q_per_kv: int = 2,
    head_dim: int = 8, block_size: int = 4, n_blocks: int = 17,
    table_blocks: int = 4, device="cpu",
) -> Dict:
    """Corroboration by instrumentation, JAX's keys at JAX's shape and
    inputs (``np.random.default_rng(0)``, drawn in JAX's order): the
    gather reference (``gather_reference``) and the paged kernel's walk run
    plainly (``paged_interpret``: ``paged_decode_attention_emulated``, the
    counterpart of JAX's Pallas interpret), each leg's ``bytes_accessed``
    and ``flops``.

    These are dispatch tallies, not XLA's cost analysis: ``flops`` is
    ``FlopCounterMode``'s count (matmul-class ops only, 2 a multiply-add);
    ``bytes_accessed`` sums each dispatched op's input and output tensor
    bytes, views skipped, with no fusion (XLA counts a fused program's
    operands once). So the numbers are the port's own: the reference's
    flops are ``kernel_traffic``'s for a full table, and the emulation's
    are 4 * bs * n * h for each block the kernel streams.

    Runs on the CPU by default, as JAX's does. With ``device="cuda"`` both
    legs are tallied on the card, each leg carries its CUDA-event
    ``device_ms`` (one call queued behind a sleep kernel; ``queued`` False
    when the host had not queued it all in time, so the time includes
    host gaps) and ``max_abs_err`` (the reference against itself in f64 on
    the CPU, the emulation against the reference), and ``paged_kernel``
    holds one launch of the Hopper kernel: ``kernel_traffic``'s ``bytes``,
    ``kernel_bytes`` and ``flops`` for the drawn lengths and the card's
    split count, its error against the reference and its device ms. The
    kernel is launched through ctypes, which a dispatch mode cannot see,
    so its counts are the model's."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g, r, h, bs, nb = kv_heads, q_per_kv, head_dim, block_size, table_blocks
    rng = np.random.default_rng(0)
    q = rng.normal(size=(slots, g * r, h))
    pk = rng.normal(size=(n_blocks, bs, g, h))
    pv = rng.normal(size=(n_blocks, bs, g, h))
    table = rng.integers(1, n_blocks, size=(slots, nb))
    lengths = rng.integers(1, nb * bs + 1, size=(slots,))
    host = [torch.tensor(x, dtype=torch.float32) for x in (q, pk, pv)] + [
        torch.tensor(x, dtype=torch.int32) for x in (table, lengths)]
    args = [x.to(dev) for x in host]
    # the kernel's own split count: the card's SMs, an H100's on the CPU
    splits = (paged_splits(slots, g, nb, _sm_count(dev.index)) if cuda
              else paged_splits(slots, g, nb))

    def tally(fn):
        with FlopCounterMode(display=False) as fc:
            fn(*args, kv_heads=g)
        with _ByteTally() as bt:
            fn(*args, kv_heads=g)
        leg = {"bytes_accessed": bt.bytes, "flops": fc.get_total_flops()}
        if not cuda:
            return leg, None
        out, leg["device_ms"], leg["queued"] = _event_ms(
            lambda: fn(*args, kv_heads=g))
        return leg, out

    def emulated(*a, kv_heads):
        return paged_decode_attention_emulated(*a, kv_heads, splits=splits)

    gather, ref = tally(paged_decode_attention_reference)
    interp, emu = tally(emulated)
    out = {
        "shape": {
            "slots": slots, "kv_heads": g, "q_per_kv": r,
            "head_dim": h, "block_size": bs, "table_blocks": nb,
        },
        "gather_reference": gather,
        "paged_interpret": interp,
    }
    if cuda:
        want = paged_decode_attention_reference(
            *(x.double() if x.is_floating_point() else x for x in host),
            kv_heads=g)
        gather["max_abs_err"] = _max_err(ref.cpu(), want)
        interp["max_abs_err"] = _max_err(emu, ref)
        PAGED_DECODE.load()
        got, ms, queued = _event_ms(
            lambda: paged_decode_attention(*args, kv_heads=g))
        kt = kernel_traffic(slots, nb, bs, g, h, 4, n_heads=g * r,
                            lengths=lengths.tolist(), splits=splits)
        out["paged_kernel"] = {
            "bytes": kt["bytes"], "kernel_bytes": kt["kernel_bytes"],
            "flops": kt["flops"], "splits": splits,
            "blocks_streamed": kt["blocks_streamed"],
            "max_abs_err": _max_err(got, ref), "device_ms": ms,
            "queued": queued,
        }
    return out


def serving_proxy_report(cfg=None) -> Dict:
    """JAX's ``serving_proxy`` payload: modeled traffic at the reference
    operating point (float and int8 pools), the measured tally
    (``xla_measured_costs``), the threshold and the resulting default,
    plus ``hopper_split_k``. Deterministic."""
    if cfg is None:
        from .transformer import ModelConfig

        # the JAX bench flagship's shape
        cfg = ModelConfig(
            vocab=32768, d_model=2048, n_heads=16, n_layers=8,
            d_ff=8192, max_seq=1024,
        )
    model = decode_step_traffic(cfg)
    model_int8 = decode_step_traffic(cfg, kv_int8=True)
    try:
        measured = xla_measured_costs()
    except Exception as e:  # noqa: BLE001 - corroboration, not decision
        measured = {"error": f"{type(e).__name__}: {e}"}
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
        "xla_cost_analysis": measured,
        "hopper_split_k": hopper_split_k(cfg),
    }
