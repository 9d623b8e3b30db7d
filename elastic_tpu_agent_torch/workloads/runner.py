"""In-pod workload runner, PyTorch port: what a pod on NVIDIA GPUs runs
under the agent.

Counterpart of ``elastic_tpu_agent/workloads/runner.py``. It reads the env
contract the hook wrote (``/run/elastic-tpu/env``), applies the HBM quota,
joins the slice's process group, runs the flagship transformer's train
loop (or decode mode) over a mesh of the slice's cards and prints one JSON
report line, with the JAX report's keys.

Usage (inside the container), one process per card::

    LOCAL_RANK=<card> LOCAL_WORLD_SIZE=<cards on this host> \
    python -m elastic_tpu_agent_torch.workloads.runner --preset small \
        --steps 20 --batch 8 --seq 256 [--dp N --sp N --tp N | --pp N] \
        [--checkpoint-dir DIR]
    python -m elastic_tpu_agent_torch.workloads.runner --mode decode \
        --preset small [--dp N --tp N] [--checkpoint-dir DIR]

**Launch shape: one runner process per card.** The JAX runner drives every
local chip from one process; the port's steps are SPMD, one rank per card
(``parallel.py``). A launcher (torchrun, or a pod's per-card containers)
starts one process per card and sets ``LOCAL_RANK`` (the card, default 0)
and ``LOCAL_WORLD_SIZE`` (processes on each host, default 1). With the
agent's slice env (``TPU_WORKER_HOSTNAMES``, ``TPU_WORKER_ID``) the rank
is ``TPU_WORKER_ID * LOCAL_WORLD_SIZE + LOCAL_RANK`` of a world of
``hosts * LOCAL_WORLD_SIZE``, the coordinator the first host at
``ELASTIC_TPU_COORD_PORT`` (8476), and the rank runs on
``cuda:LOCAL_RANK`` (``maybe_join_slice``). A world of one joins nothing
and runs the single-device step. Rank 0 alone prints the report and
writes acks, flight records, checkpoints and pre-copy deltas.

The train loop is the JAX loop step for step: restore (a delta chain
preferred over the full checkpoint), the lifecycle handshake (checkpoint
and ack on drain or reform, pre-copy delta rounds while training goes on,
the final delta at the cutover stamp or the deadline's last quarter), a
save on SIGTERM, and the ack only after the save is durable. Across ranks:

- ``--dp/--sp/--tp/--zero1/--master-weights/--accum-steps`` go through
  ``make_train_step(cfg, mesh=)``, ``--pp/--pp-schedule/--n-micro``
  through ``make_pipeline_transformer_step`` over a ``ProcessGroupPipe``;
  decode mode's ``--dp/--tp`` through ``generate(mesh=)``.
- Data. JAX's dataset batches are per host (``dp_rank`` the host,
  ``dp_size`` the hosts) and GSPMD cuts each rank's rows from their
  concatenation. Every port rank builds that same global batch, each
  host's shard in host order, and the step keeps the rank's dp rows; the
  synthetic tokens are the same on every rank.
- Agreeing to stop. Rank 0 alone polls the lifecycle spec; its signal and
  clock, and any rank's SIGTERM, are shared over the group at every poll,
  and each iteration acts on the shared values alone, so that every rank
  checkpoints, drains or cuts over at the same step.
- Checkpoints and deltas hold the whole trees (the params and the ZeRO-1
  state), gathered one leaf at a time into rank 0's host memory; a
  restore reads them on the host against a template of shapes and moves
  each rank's part to its card, so a restore at another world size
  continues the run.

Where it differs from the JAX runner:

- ``--params-dir`` (decode) serves the port's serving artifact
  (``export.py``), not JAX's orbax one.
- Seeds. ``jax.random`` streams have no torch twin: params come from
  ``init_all(torch.Generator().manual_seed(0))``, synthetic tokens from
  ``np.random.default_rng(1)`` and eval batches from
  ``default_rng(10_000 + j)``, so synthetic runs differ from the JAX
  runner's. ``--data`` runs read the same batches as the JAX runner.
- Checkpoints are the port's own format (``checkpointing.py``); the delta
  chains of pre-copy migration are the shared transport.
- Nothing is compiled ahead of time, and no warmup step applies an update
  the step count never sees: before the timer starts, the kernels are
  built (``kernels.build_all``) and one train step runs on the first batch
  on scratch copies of the params and the optimizer state, through the
  path the steps take.
- ``step_time_ms`` and ``tokens_per_s`` leave out eval only, as the JAX
  runner's do: a save's copy to the host and a pre-copy round stay in, so
  a run that streams deltas reports the throughput it kept. The flight
  recorder keeps their times apart: ``checkpoint_save``, ``precopy_round``
  and ``cutover`` records carry ``duration_ms`` (each timed after a
  synchronize), a round's also ``copy_ms``, its copy to the host. The
  loss is read on the host only where the loop needs it: eval, saves and
  the end.
- Decode mode on a multi-host slice raises, as JAX's does; on one host
  with a process group up it shards over the group.

``main(argv, device="cuda")`` runs on the card and raises when there is
none; tests pass ``device="cpu"`` (and a gloo process group).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

ENV_FILE = "/run/elastic-tpu/env"

PRESETS = {
    "tiny": dict(vocab=2048, d_model=256, n_heads=4, n_layers=2, d_ff=1024),
    "small": dict(vocab=32768, d_model=512, n_heads=8, n_layers=8, d_ff=2048),
    "medium": dict(vocab=32768, d_model=1024, n_heads=16, n_layers=12,
                   d_ff=4096),
}

DEFAULT_COORD_PORT = "8476"
# the launcher's env: this process's card, and the processes on each host
LOCAL_RANK_ENV = "LOCAL_RANK"
RANKS_PER_HOST_ENV = "LOCAL_WORLD_SIZE"
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_ONE_PER_CARD = ("the port runs one process per card: launch one runner a "
                 f"card with {LOCAL_RANK_ENV} and {RANKS_PER_HOST_ENV} set")


def load_alloc_env(path: str = "") -> dict:
    """Apply the hook-written env file (KEY=VALUE lines) to this process.

    ``path`` defaults to $ELASTIC_TPU_ENV_FILE (resolved at call time) or
    the in-container ENV_FILE. Agent values override ambient env: the
    file is the pod's allocation truth."""
    path = path or os.environ.get("ELASTIC_TPU_ENV_FILE", ENV_FILE)
    applied = {}
    if not os.path.exists(path):
        return applied
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            os.environ[key] = value
            applied[key] = value
    return applied


def apply_hbm_quota(device) -> None:
    """Cooperative HBM quota: keep the generic ``TPU_MEM_FRACTION`` knob
    the JAX runner sets, and on a card cap this process's CUDA caching
    allocator at that fraction of the card's memory
    (``torch.cuda.set_per_process_memory_fraction``)."""
    frac = os.environ.get("ELASTIC_TPU_HBM_FRACTION")
    if not frac:
        return
    os.environ.setdefault("TPU_MEM_FRACTION", frac)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_per_process_memory_fraction(float(frac), device)


@dataclasses.dataclass(frozen=True)
class SliceLayout:
    """Where this process sits in the slice (module docstring): the hosts
    of ``TPU_WORKER_HOSTNAMES`` (one, ``localhost``, when unset), this
    host's index (``TPU_WORKER_ID``), the processes on each host and this
    one's card."""

    hosts: Tuple[str, ...]
    host: int = 0
    per_host: int = 1
    local_rank: int = 0
    port: str = DEFAULT_COORD_PORT

    @property
    def world(self) -> int:
        return len(self.hosts) * self.per_host

    @property
    def rank(self) -> int:
        return self.host * self.per_host + self.local_rank

    @property
    def coordinator(self) -> str:
        return f"tcp://{self.hosts[0]}:{self.port}"


def slice_layout(env=None) -> SliceLayout:
    """The slice layout from the agent's slice env and the launcher's
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``; raises on an inconsistent one."""
    env = os.environ if env is None else env
    hosts = tuple(
        h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ) or ("localhost",)
    layout = SliceLayout(
        hosts=hosts, host=int(env.get("TPU_WORKER_ID", "0")),
        per_host=int(env.get(RANKS_PER_HOST_ENV, "1")),
        local_rank=int(env.get(LOCAL_RANK_ENV, "0")),
        port=env.get("ELASTIC_TPU_COORD_PORT", DEFAULT_COORD_PORT),
    )
    if not 0 <= layout.host < len(hosts):
        raise ValueError(
            f"TPU_WORKER_ID {layout.host} is not a host of {list(hosts)}")
    if not 0 <= layout.local_rank < layout.per_host:
        raise ValueError(
            f"{LOCAL_RANK_ENV} {layout.local_rank} is not below "
            f"{RANKS_PER_HOST_ENV} {layout.per_host}")
    return layout


def maybe_join_slice(device, layout: Optional[SliceLayout] = None) -> bool:
    """Join the slice's process group (module docstring) and return
    whether one is up. A default group that is already up is used as it
    stands; a world of one joins nothing. nccl on a card, gloo on the
    CPU, and never one for the other."""
    if dist.is_available() and dist.is_initialized():
        return True
    layout = layout or slice_layout()
    if layout.world == 1:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        _BACKENDS[device.type], init_method=layout.coordinator,
        rank=layout.rank, world_size=layout.world,
    )
    return True


def warmup_cosine_schedule(
    peak: float, warmup_steps: int, horizon: int
) -> Callable[[int], float]:
    """``count -> lr``: optax.warmup_cosine_decay_schedule(init_value=0,
    peak_value=peak, warmup_steps=warmup_steps, decay_steps=max(warmup_steps
    + 1, horizon), end_value=0.1 * peak), evaluated in float32 in optax's
    order of operations: a linear ramp to ``peak``, then a cosine decay to
    10% over the rest of the horizon."""
    f = np.float32
    decay = max(warmup_steps + 1, horizon) - warmup_steps
    end = peak * 0.1
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(count: int) -> float:
        if count < warmup_steps:
            frac = f(1) - f(max(count, 0)) / f(warmup_steps)
            return float(f(0.0 - peak) * frac + f(peak))
        c = f(min(count - warmup_steps, decay))
        cosine = f(0.5) * (f(1) + f(math.cos(f(np.pi) * c / f(decay))))
        return float(f(peak) * (f(1 - alpha) * cosine + f(alpha)))

    return lr


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m elastic_tpu_agent_torch.workloads.runner",
        description="In-pod workload runner (PyTorch, one process a CUDA "
                    "card)",
    )
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--preset", choices=sorted(PRESETS), default="small")
    parser.add_argument(
        "--kv-heads", type=int, default=0,
        help="grouped-query attention: shared k/v heads "
             "(0 = MHA; must divide the preset's n_heads)",
    )
    parser.add_argument("--dp", type=int, default=None,
                        help="data parallelism (default: the ranks left)")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence parallelism (ring attention)")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor parallelism (default 4, 2 or 1, as "
                             "the ranks divide)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages (n_layers must divide "
                             "evenly; composes with --dp only)")
    parser.add_argument("--pp-schedule", choices=("gpipe", "1f1b"),
                        default="gpipe", help="pipeline schedule (--pp > 1)")
    parser.add_argument("--n-micro", type=int, default=4,
                        help="microbatches per step (--pp > 1)")
    parser.add_argument(
        "--data", default="",
        help="ETPU token dataset (workloads/data.py) to train on; "
             "default: synthetic random tokens",
    )
    parser.add_argument(
        "--checkpoint-dir", default="",
        help="enable preemption-tolerant checkpoint/resume",
    )
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument(
        "--precopy-every", type=int, default=5,
        help="pre-copy migration: on a drain signal, stream a delta "
             "snapshot every N steps while training continues and pause "
             "only for the final delta at the cutover signal; 0 = "
             "checkpoint-and-exit on the drain signal",
    )
    parser.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler trace of the timed steps here "
             "(trace.json, for chrome://tracing or Perfetto)",
    )
    parser.add_argument(
        "--accum-steps", type=int, default=1,
        help="gradient accumulation: split --batch into this many "
             "micro-batches per optimizer update",
    )
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument(
        "--master-weights", action="store_true",
        help="store live params in the model dtype (bf16) with f32 "
             "masters inside the optimizer state",
    )
    parser.add_argument("--zero1", action="store_true",
                        help="shard optimizer state over the dp ranks "
                             "(ZeRO-1)")
    parser.add_argument(
        "--ema-decay", type=float, default=0.0,
        help="keep an EMA of params in the optimizer state (e.g. 0.999) "
             "and save it as its own checkpoint item",
    )
    parser.add_argument(
        "--warmup-steps", type=int, default=0,
        help="linear warmup to --lr then cosine decay to 10%% over "
             "--total-steps (0 = constant lr)",
    )
    parser.add_argument(
        "--total-steps", type=int, default=0,
        help="schedule horizon across all invocations of a "
             "checkpoint-resumed run (default: this run's --steps); pass "
             "the same value on every resume",
    )
    parser.add_argument(
        "--eval-every", type=int, default=0,
        help="held-out eval loss every N steps (0 = off). With --data the "
             "last --eval-frac of the file is held out of training",
    )
    parser.add_argument("--eval-batches", type=int, default=2)
    parser.add_argument("--eval-frac", type=float, default=0.1)
    parser.add_argument(
        "--mode", choices=("train", "decode"), default="train",
        help="train: timed optimizer steps (default); decode: KV-cache "
             "generation throughput, optionally from a checkpoint",
    )
    parser.add_argument("--prompt-len", type=int, default=32,
                        help="decode mode: synthetic prompt length")
    parser.add_argument("--new-tokens", type=int, default=64,
                        help="decode mode: tokens generated per sequence")
    parser.add_argument("--int8", action="store_true",
                        help="decode mode: int8 weight-only quantization "
                             "(workloads/quantize.py)")
    parser.add_argument("--params-dir", default="",
                        help="decode mode: serve a serving artifact "
                             "(workloads/export.py); its config overrides "
                             "--preset")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=0.0)
    parser.add_argument(
        "--flight-recorder", default="",
        help="write per-step flight-recorder JSONL here (default: "
             "$ELASTIC_TPU_FLIGHT_RECORDER, or in-memory only)",
    )
    return parser


def _resolve_device(device, local_rank: int = 0) -> torch.device:
    """The run's device: a card without an index is this process's card
    (``LOCAL_RANK``); asking for the card without one raises, so a run
    never carries on on the CPU."""
    from .transformer import as_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the runner was asked to run on the card (device='cuda') but "
            "torch sees no CUDA device; pass device='cpu' to run on the CPU"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return as_device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _is_root(distributed: bool) -> bool:
    return not distributed or dist.get_rank() == 0


def _emit(report: dict, root: bool) -> None:
    """The report line: rank 0 prints it."""
    if root:
        print(json.dumps(report), flush=True)


def main(argv=None, device="cuda") -> int:
    parser = _parser()
    args = parser.parse_args(argv)

    applied = load_alloc_env()
    layout = slice_layout()
    device = _resolve_device(device, layout.local_rank)
    apply_hbm_quota(device)
    if args.mode == "decode":
        if args.pp > 1 or args.sp != 1:
            parser.error("decode mode shards over dp/tp only")
        if len(layout.hosts) > 1:
            raise SystemExit(
                "decode mode is single-host: sharded params are created by "
                "device_put from host arrays, which cannot target a "
                "cross-process mesh (train mode initializes inside jit)"
            )
    distributed = maybe_join_slice(device, layout)

    from .transformer import ModelConfig

    cfg = ModelConfig(
        max_seq=args.seq, n_kv_heads=args.kv_heads, **PRESETS[args.preset]
    )
    if args.mode == "decode":
        return run_decode(args, cfg, applied, device, distributed)
    return _train(args, cfg, applied, device, parser, layout, distributed)


class _Shards:
    """How this rank's (params, opt_state) are cut from the whole trees a
    checkpoint holds. ``mesh`` is a dp/sp/tp mesh (params cut over the
    split specs, the optimizer state also over dp under ZeRO-1), ``pipe``
    a pipeline's transport (the stacked stages over pp); with neither, the
    trees are whole and every method hands them back as they are. A
    leaf's cuts are (tensor axis, group) pairs in the order they are made;
    a leaf is made whole by undoing them in reverse."""

    def __init__(self, cfg, mesh=None, optimizer=None, pipe=None):
        self.cfg, self.mesh, self.pipe = cfg, mesh, pipe
        self.zero1 = optimizer.zero1 if optimizer is not None else None
        self.sharded = mesh is not None or pipe is not None

    def _cuts(self, params):
        """({path: cuts} of a params leaf, {path: cuts} of its optimizer
        state leaf), from the shapes of ``params`` (whole or this rank's:
        ZeRO-1's axis is one that the split specs leave whole)."""
        from . import parallel
        from .quantize import _tree_map

        if self.pipe is not None:
            cuts = {}
            _tree_map(lambda path, x: cuts.__setitem__(
                path, [(0, self.pipe.group)] if path[0] == "stages"
                else []), params)
            return cuts, cuts
        specs = parallel.full_param_shardings(self.mesh, self.cfg)
        zaxes = iter(self.zero1.axes(params) if self.zero1 is not None
                     else ())
        cuts, state_cuts = {}, {}

        def leaf(path, x):
            cuts[path] = [
                (axis, self.mesh.get_group(name)) for axis, name in
                parallel._split(parallel._spec_at(specs, path), x.dim())]
            z = next(zaxes, None)
            state_cuts[path] = cuts[path] + (
                [] if z is None else [(z, self.zero1.group)])

        _tree_map(leaf, params)
        return cuts, state_cuts

    def _map(self, fn, params, opt_state):
        """fn(cuts, leaf) over both trees (the step count passes as it
        is)."""
        from .quantize import _tree_map

        cuts, state_cuts = self._cuts(params)

        def tree(t, plan):
            return _tree_map(lambda path, x: fn(plan[path], x), t)

        return tree(params, cuts), {
            k: v if k == "count" else tree(v, state_cuts)
            for k, v in opt_state.items()}

    def full(self, params, opt_state):
        """The whole trees, gathered one leaf at a time (a collective:
        every rank calls it): host copies on rank 0 and None elsewhere, so
        that no rank holds more than one whole leaf beside its own part."""
        from .parallel import _gather_axis

        if not self.sharded:
            return params, opt_state
        root = dist.get_rank() == 0
        on_card = []

        def whole(cuts, x):
            for axis, group in reversed(cuts):
                x = _gather_axis(x, axis, group)
            if not root:
                return None
            # pinned, so that the copies queue behind the gathers and
            # run at the link's rate; one synchronize below
            on_card.append(x.is_cuda)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            return host.copy_(x, non_blocking=True)

        trees = self._map(whole, params, opt_state)
        if any(on_card):
            torch.cuda.synchronize()
        return trees if root else None

    def template(self, params, opt_state):
        """The whole trees' shapes and dtypes, a restore's template: host
        stand-ins that hold one element each (``expand``), so that no
        rank allocates a whole tree for it."""
        if not self.sharded:
            return params, opt_state

        def stand_in(cuts, x):
            shape = list(x.shape)
            for axis, group in cuts:
                shape[axis] *= dist.get_world_size(group)
            return torch.empty((), dtype=x.dtype).expand(shape)

        return self._map(stand_in, params, opt_state)

    def local(self, params, opt_state, device):
        """This rank's part of the whole (restored, host) trees, on
        ``device``."""
        if not self.sharded:
            return params, opt_state

        def mine(cuts, x):
            for axis, group in cuts:
                n = x.shape[axis] // dist.get_world_size(group)
                x = x.narrow(axis, dist.get_rank(group) * n, n)
            return x.to(device, memory_format=torch.contiguous_format,
                        copy=True)

        return self._map(mine, params, opt_state)


def _agree(distributed: bool, device, sig, flag: bool):
    """(signal, clock, stop) that every rank shares: rank 0's polled
    signal and clock, and whether any rank's ``flag`` (its SIGTERM) is
    set. The loop decides an iteration from these values alone: a SIGTERM
    that lands after this call waits for the next one."""
    now = time.time()
    if not distributed:
        return sig, now, flag
    box = [sig, now]
    dist.broadcast_object_list(box, src=0)
    any_flag = torch.tensor([int(flag)], device=device)
    dist.all_reduce(any_flag, op=dist.ReduceOp.MAX)
    return box[0], box[1], bool(any_flag.item())


def _build_step(args, cfg, device, parser, distributed):
    """(train_step, init_all, shards, mesh dims, token layout):
    the pipelined step over a ("pp", "dp") mesh, the sharded step over a
    dp/sp/tp mesh of the process group, or the single-device step. The
    token layout is ``(microbatches, dp axis)``: tokens are [batch, seq+1]
    (None, 0) or [m, batch/m, seq+1] (m, 1)."""
    from .transformer import make_train_step

    world = dist.get_world_size() if distributed else 1
    if args.pp > 1:
        from . import pipeline
        from .transformer_pipeline import make_pipeline_transformer_step

        if args.accum_steps > 1:
            parser.error(
                "--accum-steps composes with the dp/sp/tp step only; "
                "pipeline mode already micro-batches via --n-micro"
            )
        if args.warmup_steps > 0:
            parser.error(
                "--warmup-steps is not supported with --pp "
                "(the pipeline step takes a constant --lr)"
            )
        if args.ema_decay > 0:
            parser.error("--ema-decay is not supported with --pp")
        if args.master_weights or args.zero1:
            parser.error(
                "--master-weights/--zero1 compose with the dp/sp/tp "
                "step only (the pipeline step owns its own state)"
            )
        if args.sp != 1 or (args.tp or 1) != 1:
            parser.error(
                "--pp composes with --dp only; --sp/--tp are not supported "
                "in pipeline mode (the pp mesh has axes pp x dp)"
            )
        if args.eval_every > 0:
            parser.error("--eval-every is not supported with --pp")
        dp = args.dp or max(1, world // args.pp)
        if args.pp * dp != world:
            parser.error(f"--pp {args.pp} x dp {dp} needs {args.pp * dp} "
                         f"ranks; the world has {world}: {_ONE_PER_CARD}")
        if args.batch % args.n_micro:
            parser.error(f"--batch {args.batch} must divide into --n-micro "
                         f"{args.n_micro}")
        if (args.batch // args.n_micro) % dp:
            parser.error(f"microbatch size {args.batch // args.n_micro} "
                         f"must be divisible by dp={dp}")
        mesh = pipeline.make_pipeline_mesh(args.pp, dp,
                                           device_type=device.type)
        train_step, init_all = make_pipeline_transformer_step(
            cfg, mesh, n_micro=args.n_micro, schedule=args.pp_schedule,
            learning_rate=args.lr, device=device,
        )
        shards = _Shards(cfg, pipe=pipeline.as_pipe(mesh))
        return (train_step, init_all, shards,
                dict(zip(mesh.mesh_dim_names, mesh.shape)),
                (args.n_micro, 1))
    if args.accum_steps < 1:
        parser.error(f"--accum-steps {args.accum_steps} must be >= 1")
    if not 0.0 <= args.ema_decay < 1.0:
        parser.error(f"--ema-decay {args.ema_decay} must be in [0, 1)")
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error(
            f"--accum-steps {args.accum_steps} must divide --batch "
            f"{args.batch}"
        )
    if args.warmup_steps > 0:
        # The horizon is --total-steps (default: this invocation's
        # --steps). The restored step count indexes the schedule, so a
        # resumed run continues the same curve when every invocation
        # passes the same --total-steps.
        lr = warmup_cosine_schedule(
            args.lr, args.warmup_steps, args.total_steps or args.steps
        )
    else:
        lr = args.lr
    mesh = None
    if distributed:
        from .parallel import make_mesh

        mesh = make_mesh(dp=args.dp, sp=args.sp, tp=args.tp,
                         device_type=device.type)
        dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
    else:
        from .parallel import mesh_shape

        try:
            dims = dict(zip(("dp", "sp", "tp", "ep"),
                            mesh_shape(1, args.dp, args.sp, args.tp)))
        except AssertionError as e:
            parser.error(f"{e}: {_ONE_PER_CARD}")
    train_step, init_all, optimizer = make_train_step(
        cfg, learning_rate=lr, accum_steps=args.accum_steps,
        ema_decay=args.ema_decay, master_weights=args.master_weights,
        zero1=args.zero1, device=device, mesh=mesh,
    )
    micro = args.accum_steps if args.accum_steps > 1 else None
    return (train_step, init_all, _Shards(cfg, mesh, optimizer), dims,
            (micro, 0 if micro is None else 1))


def _warm_up(train_step, params, opt_state, first_tokens, device) -> None:
    """First-call costs before the timer, with no update the step count
    sees: one train step on the first batch, through the path the steps
    take (the attention kernels, cuBLAS handles and heuristics, autograd,
    the loss and the collectives), on scratch copies of the params and the
    optimizer state, which leaves the caching allocator holding blocks for
    a step's temporaries."""
    from .weights import _tree_map

    def scratch(tree):
        return _tree_map(lambda _, x: x.detach().clone(), tree)

    train_step(scratch(params), scratch(opt_state), first_tokens)
    _sync(device)


def _train(args, cfg, applied, device, parser, layout, distributed) -> int:
    from .checkpointing import (
        DeltaCheckpointer,
        TrainCheckpointer,
        bytes_to_tree,
        tree_to_bytes,
    )
    from .lifecycle import (
        SIGNAL_CUTOVER,
        SIGNAL_DRAIN,
        SIGNAL_REFORM,
        LifecycleWatcher,
    )
    from .telemetry import FlightRecorder
    from .transformer import ema_params, make_eval_fn

    root = _is_root(distributed)
    world = dist.get_world_size() if distributed else 1
    (train_step, init_all, shards, mesh_dims,
     (micro, dp_axis)) = _build_step(args, cfg, device, parser, distributed)
    # tokens [batch, seq+1], or [m, batch/m, seq+1] for microbatches
    shape = ((args.batch, args.seq + 1) if micro is None
             else (micro, args.batch // micro, args.seq + 1))
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, size=shape),
        device=device,
    )
    params, opt_state = init_all(torch.Generator().manual_seed(0))

    dataset = None
    n_hosts = len(layout.hosts)
    if args.data:
        from .data import TokenDataset

        dataset = TokenDataset(args.data)
        # full-file scan: one out-of-range token anywhere corrupts training
        if dataset.max_token(sample=None) >= cfg.vocab:
            raise ValueError(
                f"dataset tokens exceed model vocab {cfg.vocab}"
            )

    # Held-out eval: with --data the file's last --eval-frac sequence
    # windows never enter training.
    train_region = eval_region = None
    eval_fn = None
    if args.eval_every > 0:
        eval_fn = make_eval_fn(cfg, device, mesh=shards.mesh)
        if dataset is not None:
            train_region, eval_region = dataset.split_regions(
                args.seq, args.eval_frac
            )

    def global_batch(step, region, m=None, axis=0):
        """Every host's shard of ``step``'s batch, in host order (each cut
        into ``m`` microbatches when given, joined along the dp axis):
        the global batch JAX assembles from the hosts' batches."""
        parts = []
        for h in range(n_hosts):
            b = dataset.batch(step, args.batch, args.seq, dp_rank=h,
                              dp_size=n_hosts, region=region)
            if m is not None:
                b = b.reshape(m, args.batch // m, -1)
            parts.append(b)
        return np.concatenate(parts, axis=axis)

    def eval_batch(j):
        if dataset is None:
            # synthetic: a fixed batch apart from the training tokens
            return np.random.default_rng(10_000 + j).integers(
                0, cfg.vocab, size=(args.batch, args.seq + 1)
            )
        return global_batch(j, eval_region)

    def tokens_for(step):
        """The step's global batch: every host's dataset shard, or the
        fixed synthetic tokens."""
        if dataset is None:
            return tokens
        return torch.as_tensor(
            global_batch(step, train_region, micro, dp_axis), device=device)

    # Preemption-tolerant resume and the migration handshake: restore the
    # newest state and save on SIGTERM; rank 0's watcher polls the alloc
    # spec for drain, reform and cutover stamps, and a replacement pod
    # resumes from the destination agent's restore stamp and acks it.
    watcher = LifecycleWatcher()
    restore_req = None
    if root and watcher.enabled:
        restore_req = watcher.restore_request()
    if root and watcher.enabled and restore_req is None:
        # The destination agent stamps the restore env up to one
        # migration tick after the bind: wait briefly for it, but not at
        # all when a populated local checkpoint dir already answers.
        has_local = False
        if args.checkpoint_dir and os.path.isdir(args.checkpoint_dir):
            try:
                has_local = bool(os.listdir(args.checkpoint_dir))
            except OSError:
                has_local = False
        wait_s = 0.0 if has_local else float(
            os.environ.get("ELASTIC_TPU_RESTORE_WAIT_S", "5")
        )
        deadline = time.monotonic() + wait_s
        while restore_req is None and time.monotonic() < deadline:
            time.sleep(0.2)
            restore_req = watcher.restore_request()
    if distributed:
        box = [restore_req]
        dist.broadcast_object_list(box, src=0)
        restore_req = box[0]
    ckpt_dir = args.checkpoint_dir
    if not ckpt_dir and restore_req:
        ckpt_dir = restore_req["checkpoint_dir"]
    ckpt = None
    start_step = 0
    resumed = False
    # set by SIGTERM and read only through _agree, so that every rank
    # stops at the same step
    sigterm = {"pending": False}
    lifecycle_sig = {"sig": None}
    old_sigterm = None
    if ckpt_dir:
        ckpt = TrainCheckpointer(ckpt_dir)
        # A pre-copy source leaves a delta chain whose final round is
        # newer than any periodic save: prefer it, and fall back to the
        # full checkpoint on a torn or corrupt chain.
        delta_ck = DeltaCheckpointer(ckpt_dir)
        delta_step = delta_ck.latest_step
        # the whole trees' shapes (a checkpoint holds them whole, so any
        # world size restores it)
        like = (shards.template(params, opt_state)
                if delta_step is not None or ckpt.latest_step is not None
                else None)
        if delta_step is not None and (
            ckpt.latest_step is None or delta_step >= ckpt.latest_step
        ):
            try:
                payload, manifest = delta_ck.load()
                params, opt_state = bytes_to_tree(payload, like)
                start_step = int(manifest["step"]) + 1
                resumed = True
            except (ValueError, OSError):
                pass  # torn chain: the full checkpoint below
        if not resumed and ckpt.latest_step is not None:
            params, opt_state, start_step = ckpt.restore(*like)
            start_step += 1
            resumed = True
        if resumed:   # the whole trees, cut for this world
            params, opt_state = shards.local(params, opt_state, device)
        del like

        def on_sigterm(signum, frame):  # noqa: ARG001
            sigterm["pending"] = True

        if threading.current_thread() is threading.main_thread():
            old_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    if root and restore_req is not None and watcher.enabled:
        # the resume ack completes the handshake: the destination agent
        # checks step >= the acked step and the current world size
        watcher.ack_resume(
            start_step - 1 if resumed else None, checkpoint_dir=ckpt_dir
        )

    if device.type == "cuda":
        from .. import kernels

        kernels.build_all()
    _warm_up(train_step, params, opt_state, tokens_for(start_step), device)

    every = max(0, args.checkpoint_every)  # 0 = save only on preemption
    # a --data step reads every host's shard: hosts x --batch rows
    tokens_per_step = args.batch * args.seq * (
        n_hosts if dataset is not None else 1)
    recorder = FlightRecorder(
        path=(args.flight_recorder or None) if root else "", device=device)
    prof = None
    if args.profile_dir and root:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
    t0 = time.perf_counter()
    ran = 0
    stop = False   # this iteration's agreed stop: save, then leave the loop
    loss = None
    last_saved_step = None
    eval_hist = []
    eval_s = 0.0  # eval wall time, left out of the step accounting
    # Pre-copy migration: on a drain signal keep training and stream
    # delta snapshots every --precopy-every steps; pause only when the
    # coordinator stamps ELASTIC_TPU_CUTOVER or, as a safety net, when the
    # drain deadline's final quarter arrives with no stamp.
    precopy = {
        "active": False, "round": 0, "delta": None, "sig": None,
        "deadline_ts": None, "seen_ts": None,
    }

    def timed_io(fn):
        """fn() after the queued steps drain; returns (fn's result, ms)."""
        _sync(device)
        t = time.perf_counter()
        out = fn()
        return out, round((time.perf_counter() - t) * 1000, 3)

    def ship_delta(kind, step):
        """One delta round of the whole (params, opt_state) (every rank
        gathers, rank 0 writes): ``precopy_round`` while training goes
        on, ``cutover`` for the final one."""
        def copy():
            whole = shards.full(params, opt_state)
            return tree_to_bytes(whole) if root else None

        payload, copy_ms = timed_io(copy)
        summary, save_ms = {}, 0.0
        if root:
            summary, save_ms = timed_io(lambda: precopy["delta"].save(
                step, payload, round_=precopy["round"],
            ))
            ms = round(copy_ms + save_ms, 3)
            recorder.record(
                kind, step=step, round=precopy["round"],
                delta_bytes=summary["delta_bytes"],
                total_bytes=summary["total_bytes"], duration_ms=ms,
                copy_ms=copy_ms,
            )
        if kind == "cutover":
            precopy.update(final=summary,
                           cutover_ms=round(copy_ms + save_ms, 3))
        return summary

    def save_checkpoint(step):
        """The whole trees (every rank gathers); rank 0 saves them."""
        whole = shards.full(params, opt_state)
        if root:
            fp, fs = whole
            ckpt.save(step, fp, fs,
                      ema=ema_params(fs) if args.ema_decay > 0 else None)

    try:
        for step in range(start_step, start_step + args.steps):
            with recorder.step(step, tokens=tokens_per_step):
                params, opt_state, loss = train_step(
                    params, opt_state, tokens_for(step)
                )
            ran += 1
            if eval_fn is not None and (step + 1) % args.eval_every == 0:
                _sync(device)
                te = time.perf_counter()
                vals = [
                    float(eval_fn(params, eval_batch(j)))
                    for j in range(max(1, args.eval_batches))
                ]
                ev_dt = time.perf_counter() - te
                eval_s += ev_dt
                eval_hist.append({
                    "step": step,
                    "loss": sum(vals) / len(vals),
                })
                recorder.record(
                    "eval", step=step, loss=eval_hist[-1]["loss"],
                    duration_ms=round(ev_dt * 1000, 3),
                )
            sig, now, stop = _agree(
                distributed, device, watcher.poll() if root else None,
                sigterm["pending"])
            if (
                sig is not None and sig.kind == SIGNAL_DRAIN
                and args.precopy_every > 0 and ckpt is not None
                and not precopy["active"]
            ):
                # pre-copy drain: training continues; deltas stream
                # below until the cutover signal
                precopy.update(
                    active=True, sig=sig, round=0,
                    deadline_ts=sig.deadline_ts, seen_ts=now,
                    delta=DeltaCheckpointer(ckpt_dir) if root else None,
                )
            elif sig is not None and sig.kind in (
                SIGNAL_DRAIN, SIGNAL_REFORM
            ):
                # checkpoint-and-exit: the save below runs this iteration
                # and the ack lands once it is durable (after ckpt.wait())
                lifecycle_sig["sig"] = sig
                stop = True
            if precopy["active"] and not stop:
                cut = sig is not None and sig.kind == SIGNAL_CUTOVER
                if not cut and precopy["deadline_ts"]:
                    budget = max(
                        0.0, precopy["deadline_ts"] - precopy["seen_ts"]
                    )
                    cut = now >= precopy["deadline_ts"] - 0.25 * budget
                if cut:
                    # cutover: training pauses here; only the blocks
                    # dirtied since the last round ship in the pause
                    ship_delta("cutover", step)
                    last_saved_step = step
                    lifecycle_sig["sig"] = precopy["sig"]
                    stop = True
                elif (step + 1) % max(1, args.precopy_every) == 0:
                    summary = ship_delta("precopy_round", step)
                    if root:
                        watcher.ack_precopy(
                            step, precopy["round"], checkpoint_dir=ckpt_dir,
                            delta_bytes=summary["delta_bytes"],
                            total_bytes=summary["total_bytes"],
                            digest=summary["chain"],
                            signal=precopy["sig"].value,
                        )
                    precopy["round"] += 1
            if ckpt is not None and (
                (stop and precopy.get("final") is None)
                or (every > 0 and (step + 1) % every == 0)
            ):
                _, ms = timed_io(lambda: save_checkpoint(step))
                # the copy to the host; a thread writes the files
                recorder.record("checkpoint_save", step=step, duration_ms=ms)
                last_saved_step = step
            if stop:
                break
        _sync(device)
        # the clock stops before the profiler writes its trace
        dt = time.perf_counter() - t0 - eval_s
    finally:
        # stop even on a mid-loop failure: the crashed run is the one
        # whose trace is wanted
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
    if ckpt is not None:
        ckpt.wait()
        if precopy["active"] and precopy.get("final") is None and ran:
            # the step budget ran out mid-stream with no cutover stamp:
            # close the stream with a final delta so the agent gets its
            # cutover ack instead of waiting out the deadline
            ship_delta("cutover", step)
            last_saved_step = step
            lifecycle_sig["sig"] = lifecycle_sig["sig"] or precopy["sig"]
        sig = lifecycle_sig["sig"]
        if root and sig is not None and last_saved_step is not None:
            digest = None
            extra = None
            if precopy.get("final") is not None:
                summary = precopy["final"]
                digest = summary["chain"]
                extra = {
                    "precopy_rounds": precopy["round"],
                    "delta_bytes": summary["delta_bytes"],
                    "full_bytes": summary["total_bytes"],
                    "cutover_ms": precopy["cutover_ms"],
                }
            # the checkpoint is durable (wait() returned): only now is the
            # ack honest, since the agent reclaims the card on it
            watcher.ack(
                last_saved_step, checkpoint_dir=ckpt_dir,
                signal=sig.value, epoch=sig.epoch,
                digest=digest, extra=extra,
            )
        ckpt.close()

    report = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "devices": world,
        "mesh": mesh_dims,
        "steps": ran,
        "start_step": start_step,
        "final_loss": float(loss) if loss is not None else None,
        "step_time_ms": dt / max(1, ran) * 1000,
        "tokens_per_s": tokens_per_step * ran / dt,
        "alloc_env": applied,
        "preempted": stop,
        "lifecycle_signal": (
            lifecycle_sig["sig"].kind if lifecycle_sig["sig"] else None
        ),
        "resumed_from_migration": restore_req is not None,
        "precopy_rounds": precopy["round"] if precopy["active"] else 0,
    }
    if eval_hist:
        report["eval"] = eval_hist
    if args.warmup_steps > 0:
        report["lr_schedule"] = {
            "peak": args.lr, "warmup_steps": args.warmup_steps,
        }
    recorder.record("run_summary", **{
        k: report[k] for k in ("steps", "step_time_ms", "tokens_per_s")
    })
    report["flight_recorder"] = recorder.summary()
    recorder.close()
    _emit(report, root)
    return 0


def decode_prompt(cfg, batch: int, prompt_len: int) -> np.ndarray:
    """Decode mode's synthetic prompts [batch, prompt_len] (numpy seed 1;
    the JAX runner draws its own from ``jax.random.key(1)``)."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab, size=(batch, prompt_len))


def run_decode(args, cfg, applied, device, distributed=False) -> int:
    """Decode-mode body: synthetic prompts -> KV-cache generation
    throughput. Weights come from --params-dir (a serving artifact,
    ``export.py``: its config overrides --preset), from --checkpoint-dir
    (params only, stored in the model dtype) or a fresh init. ``--int8``
    quantizes the weights on the way in, from f32 params as the JAX
    runner's are, so that the int8 tree is the JAX runner's on the same
    weights. With a process group up, the decode shards over a (dp, 1,
    tp) mesh of it (``decode_shardings``); every rank decodes, rank 0
    reports."""
    from .checkpointing import TrainCheckpointer
    from .generate import decode_shardings, generate
    from .transformer import init_params

    artifact_params = None
    if args.params_dir:
        if args.checkpoint_dir:
            raise SystemExit(
                "--params-dir and --checkpoint-dir are exclusive "
                "(an artifact already IS the exported checkpoint)"
            )
        from .export import load_artifact

        artifact_params, cfg = load_artifact(args.params_dir, device=device)

    max_len = args.prompt_len + args.new_tokens
    if cfg.pos == "learned" and cfg.max_seq < max_len:
        if args.checkpoint_dir or args.params_dir:
            # a trained position table has the trained length
            raise SystemExit(
                f"decode length {max_len} exceeds the trained max_seq "
                f"{cfg.max_seq}; shorten --prompt-len/--new-tokens or "
                "retrain with a longer --seq"
            )
        cfg = dataclasses.replace(cfg, max_seq=max_len)

    restored_step = None
    if artifact_params is not None:
        params, restored_step = artifact_params, "artifact"
        if not args.int8:   # float leaves in the model dtype, as below
            from .quantize import _tree_map, is_quantized

            params = _tree_map(
                lambda path, t: t if is_quantized(t) or path[-1] == "wg"
                else t.to(cfg.dtype), params)
    else:
        # int8 quantizes f32 weights (the JAX tree's dtype); the leaves it
        # leaves float are cast to cfg.dtype at use
        stored = torch.float32 if args.int8 else None
        params = init_params(
            cfg, torch.Generator().manual_seed(0), device, dtype=stored
        )
    if args.checkpoint_dir:
        ckpt = TrainCheckpointer(args.checkpoint_dir)
        if ckpt.latest_step is None:
            # decode mode is restore-only: random init would silently
            # benchmark an untrained model
            raise SystemExit(
                f"--checkpoint-dir {args.checkpoint_dir} holds no "
                "checkpoint (decode mode serves trained params; train "
                "first or drop the flag)"
            )
        params, restored_step = ckpt.restore_params(params)
        ckpt.close()
    if args.int8:
        from .quantize import quantize_params

        params = quantize_params(params)

    # with a process group up, shard as train mode does (an unsharded
    # run would report every rank for one card's throughput)
    mesh = None
    if distributed:
        from .parallel import make_mesh, shard_params

        mesh = make_mesh(dp=args.dp, sp=1, tp=args.tp, ep=1,
                         device_type=device.type)
        params = shard_params(params, mesh, cfg,
                              decode_shardings(mesh, cfg, params)[0])

    prompt = torch.as_tensor(
        decode_prompt(cfg, args.batch, args.prompt_len), device=device
    )

    def timed(n):
        def once():
            out = generate(
                params, prompt, cfg, max_new_tokens=n,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, max_len=max_len, device=device, mesh=mesh,
            )
            _sync(device)
            return out

        once()  # first-call costs
        t0 = time.perf_counter()
        out = once()
        return out, time.perf_counter() - t0

    # prefill + 1 isolates the prompt pass, so that prefill is not billed
    # to the per-token decode rate
    _, dt_prefill = timed(1)
    out, dt_full = timed(args.new_tokens)
    decode_dt = dt_full - dt_prefill
    decode_steps = args.new_tokens - 1
    # two independent wall clocks: when prefill dominates, their noise can
    # exceed the decode time; report null rather than a sub-noise rate
    measurable = decode_steps > 0 and decode_dt > 0.02 * dt_full

    report = {
        "mode": "decode",
        "platform": "gpu" if device.type == "cuda" else device.type,
        "devices": dist.get_world_size() if distributed else 1,
        "mesh": (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else None),
        "batch": args.batch,
        "prompt_len": args.prompt_len,
        "new_tokens": args.new_tokens,
        "int8": bool(args.int8),
        "restored_step": restored_step,
        "prefill_ms": dt_prefill * 1000,
        "decode_tokens_per_s": (
            args.batch * decode_steps / decode_dt if measurable else None
        ),
        "ms_per_token": (
            decode_dt / decode_steps * 1000 if measurable else None
        ),
        "end_to_end_s": dt_full,
        "sample_tail": [int(t) for t in out[0, -5:]],
        "alloc_env": applied,
    }
    _emit(report, _is_root(distributed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
