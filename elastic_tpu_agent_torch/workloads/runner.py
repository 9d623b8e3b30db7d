"""In-pod workload runner, PyTorch port: what a pod on an NVIDIA GPU runs
under the agent.

Counterpart of ``elastic_tpu_agent/workloads/runner.py``. It reads the env
contract the hook wrote (``/run/elastic-tpu/env``), applies the HBM quota,
runs the flagship transformer's train loop on one card (or decode mode)
and prints one JSON report line, with the JAX report's keys.

Usage (inside the container)::

    python -m elastic_tpu_agent_torch.workloads.runner --preset small \\
        --steps 20 --batch 8 --seq 256 [--checkpoint-dir DIR]
    python -m elastic_tpu_agent_torch.workloads.runner --mode decode \\
        --preset small [--checkpoint-dir DIR]

The train loop is the JAX loop step for step: restore (a delta chain
preferred over the full checkpoint), the lifecycle handshake (checkpoint
and ack on drain or reform, pre-copy delta rounds while training goes on,
the final delta at the cutover stamp or the deadline's last quarter), a
save on SIGTERM, and the ack only after the save is durable. Where it
differs:

- One card. ``--dp``/``--sp``/``--tp`` above 1, ``--pp`` above 1 and
  ``--zero1`` end in a usage error, and a multi-host
  ``TPU_WORKER_HOSTNAMES`` raises: the runner must first join a process
  group from its launch env (ROADMAP Queue 1 item 4f; the sharded step
  itself is ``make_train_step(..., mesh=)``).
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
  built (``kernels.build_all``), one forward and backward runs on the
  first batch through the path the steps take, and one optimizer step
  runs on a scratch copy of the params with a fresh state.
- ``step_time_ms`` and ``tokens_per_s`` leave out eval only, as the JAX
  runner's do: a save's copy to the host and a pre-copy round stay in, so
  a run that streams deltas reports the throughput it kept. The flight
  recorder keeps their times apart: ``checkpoint_save``, ``precopy_round``
  and ``cutover`` records carry ``duration_ms`` (each timed after a
  synchronize), a round's also ``copy_ms``, its copy to the host. The
  loss is read on the host only where the loop needs it: eval, saves and
  the end.

``main(argv, device="cuda")`` runs on the card and raises when there is
none; tests pass ``device="cpu"``.
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
from typing import Callable

import numpy as np
import torch

ENV_FILE = "/run/elastic-tpu/env"

PRESETS = {
    "tiny": dict(vocab=2048, d_model=256, n_heads=4, n_layers=2, d_ff=1024),
    "small": dict(vocab=32768, d_model=512, n_heads=8, n_layers=8, d_ff=2048),
    "medium": dict(vocab=32768, d_model=1024, n_heads=16, n_layers=12,
                   d_ff=4096),
}

_MULTI_GPU = ("it comes with the multi-GPU slice of the port (ROADMAP "
              "Queue 1 item 4f: the runner's multi-host join)")


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


def maybe_join_slice() -> None:
    """A single host needs nothing; a multi-host slice (the agent injected
    several ``TPU_WORKER_HOSTNAMES``) would join one process group across
    hosts, which the port does not do yet."""
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if "," not in hostnames:
        return
    raise NotImplementedError(
        f"a multi-host slice ({hostnames}) joins one process group across "
        f"hosts: {_MULTI_GPU}"
    )


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
        description="In-pod workload runner (PyTorch, one CUDA card)",
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
                        help="data parallelism (1 only: one card)")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence parallelism (1 only: one card)")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor parallelism (1 only: one card)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages (1 only: one card)")
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
                        help="shard optimizer state over dp ranks "
                             "(multi-GPU only)")
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


def _resolve_device(device) -> torch.device:
    """The run's device; asking for the card without one raises, so a run
    never carries on on the CPU."""
    from .transformer import as_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the runner was asked to run on the card (device='cuda') but "
            "torch sees no CUDA device; pass device='cpu' to run on the CPU"
        )
    return as_device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device="cuda") -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if (args.dp or 1) > 1 or args.sp > 1 or (args.tp or 1) > 1:
        parser.error(f"--dp/--sp/--tp above 1 shard over cards: {_MULTI_GPU}")
    if args.pp > 1:
        parser.error(f"--pp above 1 stages the model over cards: {_MULTI_GPU}")
    if args.zero1:
        parser.error(f"--zero1 shards the optimizer over cards: {_MULTI_GPU}")

    applied = load_alloc_env()
    device = _resolve_device(device)
    apply_hbm_quota(device)
    maybe_join_slice()

    from .transformer import ModelConfig

    cfg = ModelConfig(
        max_seq=args.seq, n_kv_heads=args.kv_heads, **PRESETS[args.preset]
    )
    if args.mode == "decode":
        return run_decode(args, cfg, applied, device)
    if args.accum_steps < 1:
        parser.error(f"--accum-steps {args.accum_steps} must be >= 1")
    if not 0.0 <= args.ema_decay < 1.0:
        parser.error(f"--ema-decay {args.ema_decay} must be in [0, 1)")
    if args.accum_steps > 1 and args.batch % args.accum_steps:
        parser.error(
            f"--accum-steps {args.accum_steps} must divide --batch "
            f"{args.batch}"
        )
    return _train(args, cfg, applied, device)


def _warm_up(cfg, optimizer, params, first_tokens, device) -> None:
    """First-call costs before the timer, with no update the step count
    sees: one forward and backward on the first batch through the path
    the steps take (the attention kernels, cuBLAS handles and heuristics,
    autograd, the loss), then one optimizer step with those gradients on a
    scratch copy of the params and a fresh state, which leaves the caching
    allocator holding blocks for a step's temporaries."""
    from .transformer import loss_and_grads
    from .weights import _tree_map

    _, grads = loss_and_grads(params, first_tokens, cfg, device)
    scratch = _tree_map(lambda _, p: p.detach().clone(), params)
    optimizer.update_(grads, optimizer.init(scratch), scratch)
    _sync(device)


def _train(args, cfg, applied, device) -> int:
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
    from .transformer import ema_params, make_eval_fn, make_train_step

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
    train_step, init_all, optimizer = make_train_step(
        cfg, learning_rate=lr, accum_steps=args.accum_steps,
        ema_decay=args.ema_decay, master_weights=args.master_weights,
        device=device,
    )
    shape = (
        (args.batch, args.seq + 1) if args.accum_steps == 1
        else (args.accum_steps, args.batch // args.accum_steps, args.seq + 1)
    )
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, size=shape),
        device=device,
    )
    params, opt_state = init_all(torch.Generator().manual_seed(0))

    dataset = None
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
        eval_fn = make_eval_fn(cfg, device)
        if dataset is not None:
            train_region, eval_region = dataset.split_regions(
                args.seq, args.eval_frac
            )

    def eval_batch(j):
        if dataset is None:
            # synthetic: a fixed batch apart from the training tokens
            return np.random.default_rng(10_000 + j).integers(
                0, cfg.vocab, size=(args.batch, args.seq + 1)
            )
        return dataset.batch(j, args.batch, args.seq, region=eval_region)

    def tokens_for(step):
        """The step's batch: its dataset shard or the fixed synthetic
        tokens."""
        if dataset is None:
            return tokens
        b = dataset.batch(step, args.batch, args.seq, region=train_region)
        if args.accum_steps > 1:
            b = b.reshape(args.accum_steps, args.batch // args.accum_steps, -1)
        return torch.as_tensor(b, device=device)

    # Preemption-tolerant resume and the migration handshake: restore the
    # newest state and save on SIGTERM; the watcher polls the alloc spec
    # for drain, reform and cutover stamps, and a replacement pod resumes
    # from the destination agent's restore stamp and acks the resume.
    watcher = LifecycleWatcher()
    restore_req = watcher.restore_request() if watcher.enabled else None
    if watcher.enabled and restore_req is None:
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
    ckpt_dir = args.checkpoint_dir
    if not ckpt_dir and restore_req:
        ckpt_dir = restore_req["checkpoint_dir"]
    ckpt = None
    start_step = 0
    resumed = False
    preempted = {"flag": False}
    lifecycle_sig = {"sig": None}
    old_sigterm = None
    if ckpt_dir:
        ckpt = TrainCheckpointer(ckpt_dir)
        # A pre-copy source leaves a delta chain whose final round is
        # newer than any periodic save: prefer it, and fall back to the
        # full checkpoint on a torn or corrupt chain.
        delta_ck = DeltaCheckpointer(ckpt_dir)
        delta_step = delta_ck.latest_step
        if delta_step is not None and (
            ckpt.latest_step is None or delta_step >= ckpt.latest_step
        ):
            try:
                payload, manifest = delta_ck.load()
                params, opt_state = bytes_to_tree(
                    payload, (params, opt_state)
                )
                start_step = int(manifest["step"]) + 1
                resumed = True
            except (ValueError, OSError):
                pass  # torn chain: the full checkpoint below
        if not resumed and ckpt.latest_step is not None:
            params, opt_state, start_step = ckpt.restore(params, opt_state)
            start_step += 1
            resumed = True

        def on_sigterm(signum, frame):  # noqa: ARG001
            preempted["flag"] = True

        if threading.current_thread() is threading.main_thread():
            old_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
    if restore_req is not None and watcher.enabled:
        # the resume ack completes the handshake: the destination agent
        # checks step >= the acked step and the current world size
        watcher.ack_resume(
            start_step - 1 if resumed else None, checkpoint_dir=ckpt_dir
        )

    if device.type == "cuda":
        from .. import kernels

        kernels.build_all()
    first = tokens_for(start_step)
    _warm_up(cfg, optimizer, params,
             first[0] if args.accum_steps > 1 else first, device)

    every = max(0, args.checkpoint_every)  # 0 = save only on preemption
    tokens_per_step = args.batch * args.seq
    recorder = FlightRecorder(path=args.flight_recorder or None,
                              device=device)
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
    t0 = time.perf_counter()
    ran = 0
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
        """One delta round of (params, opt_state): ``precopy_round``
        while training goes on, ``cutover`` for the final one."""
        payload, copy_ms = timed_io(
            lambda: tree_to_bytes((params, opt_state)))
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
            precopy.update(final=summary, cutover_ms=ms)
        return summary

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
            sig = watcher.poll()
            if (
                sig is not None and sig.kind == SIGNAL_DRAIN
                and args.precopy_every > 0 and ckpt is not None
                and not precopy["active"]
            ):
                # pre-copy drain: training continues; deltas stream
                # below until the cutover signal
                precopy.update(
                    active=True, sig=sig, round=0,
                    deadline_ts=sig.deadline_ts, seen_ts=time.time(),
                    delta=DeltaCheckpointer(ckpt_dir),
                )
            elif sig is not None and sig.kind in (
                SIGNAL_DRAIN, SIGNAL_REFORM
            ):
                # checkpoint-and-exit: the save below runs this iteration
                # and the ack lands once it is durable (after ckpt.wait())
                lifecycle_sig["sig"] = sig
                preempted["flag"] = True
            if precopy["active"] and not preempted["flag"]:
                cut = sig is not None and sig.kind == SIGNAL_CUTOVER
                if not cut and precopy["deadline_ts"]:
                    budget = max(
                        0.0, precopy["deadline_ts"] - precopy["seen_ts"]
                    )
                    cut = time.time() >= (
                        precopy["deadline_ts"] - 0.25 * budget
                    )
                if cut:
                    # cutover: training pauses here; only the blocks
                    # dirtied since the last round ship in the pause
                    ship_delta("cutover", step)
                    last_saved_step = step
                    lifecycle_sig["sig"] = precopy["sig"]
                    preempted["flag"] = True
                elif (step + 1) % max(1, args.precopy_every) == 0:
                    summary = ship_delta("precopy_round", step)
                    watcher.ack_precopy(
                        step, precopy["round"], checkpoint_dir=ckpt_dir,
                        delta_bytes=summary["delta_bytes"],
                        total_bytes=summary["total_bytes"],
                        digest=summary["chain"],
                        signal=precopy["sig"].value,
                    )
                    precopy["round"] += 1
            if ckpt is not None and (
                (preempted["flag"] and precopy.get("final") is None)
                or (every > 0 and (step + 1) % every == 0)
            ):
                _, ms = timed_io(lambda: ckpt.save(
                    step, params, opt_state,
                    ema=ema_params(opt_state) if args.ema_decay > 0
                    else None,
                ))
                # the copy to the host; a thread writes the files
                recorder.record("checkpoint_save", step=step, duration_ms=ms)
                last_saved_step = step
            if preempted["flag"]:
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
        if sig is not None and last_saved_step is not None:
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
        "devices": 1,
        "mesh": {"dp": 1, "sp": 1, "tp": 1, "ep": 1},
        "steps": ran,
        "start_step": start_step,
        "final_loss": float(loss) if loss is not None else None,
        "step_time_ms": dt / max(1, ran) * 1000,
        "tokens_per_s": tokens_per_step * ran / dt,
        "alloc_env": applied,
        "preempted": preempted["flag"],
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
    print(json.dumps(report), flush=True)
    return 0


def decode_prompt(cfg, batch: int, prompt_len: int) -> np.ndarray:
    """Decode mode's synthetic prompts [batch, prompt_len] (numpy seed 1;
    the JAX runner draws its own from ``jax.random.key(1)``)."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab, size=(batch, prompt_len))


def run_decode(args, cfg, applied, device) -> int:
    """Decode-mode body: synthetic prompts -> KV-cache generation
    throughput. Weights come from --params-dir (a serving artifact,
    ``export.py``: its config overrides --preset), from --checkpoint-dir
    (params only, stored in the model dtype) or a fresh init. ``--int8``
    quantizes the weights on the way in, from f32 params as the JAX
    runner's are, so that the int8 tree is the JAX runner's on the same
    weights."""
    from .checkpointing import TrainCheckpointer
    from .generate import generate
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

    prompt = torch.as_tensor(
        decode_prompt(cfg, args.batch, args.prompt_len), device=device
    )

    def timed(n):
        def once():
            out = generate(
                params, prompt, cfg, max_new_tokens=n,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, max_len=max_len, device=device,
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
        "devices": 1,
        "mesh": None,
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
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
