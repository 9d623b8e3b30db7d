"""In-pod lifecycle watcher: the workload's half of the migration handshake.

Counterpart of ``elastic_tpu_agent/workloads/lifecycle.py``, with the
same files and fields, so the agent's ``MigrationCoordinator`` reads a
port pod's acks as it reads a JAX pod's:

1. :class:`LifecycleWatcher` polls the pod's own alloc-spec file
   (``<alloc dir>/<TPU hash>.json``) for drain signals, the pre-copy
   cutover, throttle deadlines and slice-epoch bumps. Mid-run restamps
   land only in the spec, so the spec is what a live workload watches.
2. On a signal edge the caller checkpoints (the runner: a
   ``TrainCheckpointer`` save or a final delta; serving:
   :func:`drain_serving`).
3. :func:`write_checkpoint_ack` publishes an atomic
   ``<alloc dir>/ack/<TPU hash>.json`` (checkpoint step, directory
   digest, wall time) once the checkpoint is durable, so the agent can
   reclaim the card at once instead of at the deadline.
4. A replacement pod finds ``ELASTIC_TPU_RESTORE_DIR``/``_RESTORE_STEP``,
   restores, and acks again (``kind="resume"``) so the destination agent
   can verify the resume (step >= acked step, world size == current
   slice).

Dependency-free (json/os/time) and never load-bearing: every file
operation swallows errors, since a full disk must not fail a train step.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Callable, Dict, Optional

from .contract import (
    AckSubdir,
    EnvAllocationHash,
    EnvAllocationHashCompat,
    EnvCutover,
    EnvDrain,
    EnvDrainDeadline,
    EnvRestoreDir,
    EnvRestoreStep,
    EnvRestoreTrace,
    EnvSliceEpoch,
    EnvThrottle,
    EnvThrottleDeadline,
)

logger = logging.getLogger(__name__)

# The shared alloc dir (the native hook's override env, hostPath-mounted
# into cooperating pods).
ENV_ALLOC_DIR = "ELASTIC_TPU_ALLOC_DIR"

DEFAULT_POLL_INTERVAL_S = 1.0

# Signal kinds, in escalation order.
SIGNAL_DRAIN = "drain"        # ELASTIC_TPU_DRAIN appeared/changed
SIGNAL_CUTOVER = "cutover"    # ELASTIC_TPU_CUTOVER stamped (pre-copy end)
SIGNAL_THROTTLE = "throttle"  # ELASTIC_TPU_THROTTLE deadline armed
SIGNAL_REFORM = "reform"      # ELASTIC_TPU_SLICE_EPOCH bumped


class Signal:
    """One observed lifecycle signal edge."""

    __slots__ = ("kind", "value", "deadline_ts", "epoch", "env")

    def __init__(self, kind, value="", deadline_ts=None, epoch=None,
                 env=None):
        self.kind = kind
        self.value = value
        self.deadline_ts = deadline_ts
        self.epoch = epoch
        self.env = dict(env or {})

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Signal(kind={self.kind!r}, value={self.value!r}, "
                f"deadline_ts={self.deadline_ts}, epoch={self.epoch})")


def _env_float(env: Dict[str, str], key: str) -> Optional[float]:
    try:
        return float(env[key])
    except (KeyError, TypeError, ValueError):
        return None


def world_size_of(env: Dict[str, str]) -> int:
    """The slice world size the stamped env describes (hosts in
    ``TPU_WORKER_HOSTNAMES``, 1 when unset): what a resume ack reports."""
    hosts = [h for h in (env.get("TPU_WORKER_HOSTNAMES") or "").split(",")
             if h]
    return max(1, len(hosts))


def checkpoint_digest(directory: str, max_files: int = 4096) -> str:
    """Content-identity digest of a checkpoint directory: a blake2b over
    the sorted (relative path, size) listing. Reads no data, so it is
    cheap for checkpoints of GBs; the destination can tell that the
    directory it restores from is the one the source acked."""
    h = hashlib.blake2b(digest_size=16)
    entries = []
    try:
        for root, dirs, files in os.walk(directory):
            dirs.sort()
            for name in sorted(files):
                path = os.path.join(root, name)
                try:
                    size = os.stat(path).st_size
                except OSError:
                    size = -1
                entries.append((os.path.relpath(path, directory), size))
                if len(entries) >= max_files:
                    raise StopIteration
    except StopIteration:
        pass
    except OSError:
        return ""
    for rel, size in entries:
        h.update(rel.encode("utf-8", "replace"))
        h.update(str(size).encode())
        h.update(b"\0")
    return h.hexdigest()


def write_checkpoint_ack(
    alloc_spec_dir: str,
    alloc_hash: str,
    step: Optional[int],
    checkpoint_dir: str = "",
    kind: str = "checkpoint",
    signal: str = "",
    world_size: Optional[int] = None,
    epoch: Optional[int] = None,
    digest: Optional[str] = None,
    ts: Optional[float] = None,
    extra: Optional[Dict] = None,
) -> bool:
    """Publish the workload's checkpoint acknowledgement to the agent.

    Written only after the checkpoint is committed, so an ack on disk
    means the work is safe and the agent may reclaim the card. Atomic
    (fixed temp name + rename), never raises; True when the ack landed.
    ``extra`` adds JSON-safe fields without shadowing the contract keys:
    the pre-copy protocol rides there (``round``/``delta_bytes``/
    ``total_bytes`` on ``kind="precopy"`` acks, ``precopy_rounds``/
    ``full_bytes``/``cutover_ms`` on the final cutover ack).
    """
    ack_dir = os.path.join(alloc_spec_dir, AckSubdir)
    path = os.path.join(ack_dir, f"{alloc_hash}.json")
    tmp = f"{path}.tmp"
    payload = {}
    if extra:
        payload.update({
            k: v for k, v in extra.items() if isinstance(k, str)
        })
    payload.update({
        "ts": time.time() if ts is None else ts,
        "kind": kind,
        "step": step,
        "checkpoint_dir": checkpoint_dir,
        "digest": (
            digest if digest is not None
            else (checkpoint_digest(checkpoint_dir) if checkpoint_dir
                  else "")
        ),
    })
    if signal:
        payload["signal"] = signal
    if world_size is not None:
        payload["world_size"] = int(world_size)
    if epoch is not None:
        payload["epoch"] = int(epoch)
    try:
        os.makedirs(ack_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def read_checkpoint_ack(
    alloc_spec_dir: str, alloc_hash: str
) -> Optional[dict]:
    """The pod's newest ack, or None when absent or torn."""
    try:
        with open(os.path.join(
            alloc_spec_dir, AckSubdir, f"{alloc_hash}.json"
        )) as f:
            ack = json.load(f)
    except (OSError, ValueError):
        return None
    return ack if isinstance(ack, dict) else None


class LifecycleWatcher:
    """Poll the pod's alloc-spec env for checkpoint-restore signals.

    ``alloc_spec_dir``/``alloc_hash`` default from the environment
    (``ELASTIC_TPU_ALLOC_DIR`` and the agent-injected ``TPU`` hash, the
    legacy ``GPU`` spelling accepted); a pod outside the agent contract
    gets an inert watcher (``enabled`` False, ``poll`` always None).

    ``checkpoint_fn(signal) -> (step, checkpoint_dir)`` is optional: when
    set, :meth:`poll` handles a signal end to end (checkpoint + ack).
    Without it the caller checkpoints itself and calls :meth:`ack`.

    Each distinct drain trigger, cutover, throttle value and slice epoch
    fires once (the agent re-asserts the stamp every tick).
    """

    def __init__(
        self,
        alloc_spec_dir: Optional[str] = None,
        alloc_hash: Optional[str] = None,
        checkpoint_fn: Optional[Callable[[Signal], tuple]] = None,
        poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        self.alloc_spec_dir = (
            alloc_spec_dir if alloc_spec_dir is not None
            else os.environ.get(ENV_ALLOC_DIR, "")
        )
        self.alloc_hash = (
            alloc_hash if alloc_hash is not None
            else (os.environ.get(EnvAllocationHash)
                  or os.environ.get(EnvAllocationHashCompat, ""))
        )
        self.checkpoint_fn = checkpoint_fn
        self.poll_interval_s = poll_interval_s
        self._time = time_fn
        self._next_poll = 0.0
        self._seen_drain: Optional[str] = None
        self._drain_active = False  # env carries a drain stamp NOW
        self._seen_cutover: Optional[str] = None
        self._seen_throttle: Optional[str] = None
        self._seen_epoch: Optional[int] = None
        self._epoch_armed = False  # first sighting sets the baseline
        self.signals_seen = 0
        self.acks_written = 0
        self.last_signal: Optional[Signal] = None

    @property
    def enabled(self) -> bool:
        return bool(self.alloc_spec_dir and self.alloc_hash)

    @property
    def draining(self) -> bool:
        """True while the spec env carries a drain stamp (as of the last
        poll). Not derived from ``last_signal``: a later throttle or
        reform edge must not reopen admissions on a node whose card is
        going away; only the drain stamp clearing does."""
        return self._drain_active

    # -- reading the contract surfaces ----------------------------------------

    def read_env(self) -> Dict[str, str]:
        """The pod's current stamped env: the alloc-spec file's env map,
        {} when unreadable."""
        if not self.enabled:
            return {}
        try:
            with open(os.path.join(
                self.alloc_spec_dir, f"{self.alloc_hash}.json"
            )) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return {}
        env = spec.get("env") if isinstance(spec, dict) else None
        return dict(env) if isinstance(env, dict) else {}

    def restore_request(self) -> Optional[dict]:
        """The destination agent's restore stamp, if any:
        {"checkpoint_dir", "step", "trace"} from
        ELASTIC_TPU_RESTORE_DIR/_STEP/_TRACE (spec env first, the ambient
        env of the boot snapshot as fallback)."""
        env = self.read_env()
        directory = env.get(EnvRestoreDir) or os.environ.get(
            EnvRestoreDir, ""
        )
        if not directory:
            return None
        step_raw = env.get(EnvRestoreStep) or os.environ.get(
            EnvRestoreStep, ""
        )
        try:
            step = int(step_raw)
        except (TypeError, ValueError):
            step = None
        return {
            "checkpoint_dir": directory,
            "step": step,
            "trace": env.get(EnvRestoreTrace)
            or os.environ.get(EnvRestoreTrace, ""),
        }

    # -- polling --------------------------------------------------------------

    def _detect(self, env: Dict[str, str]) -> Optional[Signal]:
        drain = env.get(EnvDrain)
        self._drain_active = bool(drain)
        if drain and drain != self._seen_drain:
            self._seen_drain = drain
            return Signal(
                SIGNAL_DRAIN, value=drain,
                deadline_ts=_env_float(env, EnvDrainDeadline), env=env,
            )
        if not drain:
            self._seen_drain = None  # cancelled drain re-arms the edge
        # Cutover outranks everything below: it arrives only mid-drain and
        # ends the pre-copy stream: pause, ship the final delta, ack.
        cutover = env.get(EnvCutover)
        if cutover and cutover != self._seen_cutover:
            self._seen_cutover = cutover
            return Signal(
                SIGNAL_CUTOVER, value=cutover,
                deadline_ts=_env_float(env, EnvDrainDeadline), env=env,
            )
        if not cutover:
            self._seen_cutover = None
        throttle = env.get(EnvThrottle)
        if throttle and throttle != self._seen_throttle:
            self._seen_throttle = throttle
            return Signal(
                SIGNAL_THROTTLE, value=throttle,
                deadline_ts=_env_float(env, EnvThrottleDeadline), env=env,
            )
        if not throttle:
            self._seen_throttle = None
        epoch_raw = env.get(EnvSliceEpoch)
        if epoch_raw is not None:
            try:
                epoch = int(epoch_raw)
            except (TypeError, ValueError):
                epoch = None
            if epoch is not None:
                if not self._epoch_armed:
                    # the epoch the pod started at is its baseline
                    self._epoch_armed = True
                    self._seen_epoch = epoch
                elif self._seen_epoch is not None and epoch > self._seen_epoch:
                    self._seen_epoch = epoch
                    return Signal(
                        SIGNAL_REFORM, value=str(epoch), epoch=epoch,
                        env=env,
                    )
                else:
                    self._seen_epoch = epoch
        return None

    def poll(self, force: bool = False) -> Optional[Signal]:
        """Check for a new signal (rate-limited to ``poll_interval_s``;
        ``force`` skips the limiter). With ``checkpoint_fn`` set, a signal
        is handled inline: the callback checkpoints and returns ``(step,
        checkpoint_dir)``, and the ack is written before poll() returns."""
        if not self.enabled:
            return None
        now = self._time()
        if not force and now < self._next_poll:
            return None
        self._next_poll = now + self.poll_interval_s
        env = self.read_env()
        if not env:
            return None
        sig = self._detect(env)
        if sig is None:
            return None
        self.signals_seen += 1
        self.last_signal = sig
        logger.warning(
            "lifecycle: %s signal (%s; deadline_ts=%s epoch=%s)",
            sig.kind, sig.value, sig.deadline_ts, sig.epoch,
        )
        if self.checkpoint_fn is not None:
            try:
                step, ckpt_dir = self.checkpoint_fn(sig)
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("lifecycle: checkpoint callback failed")
                return sig
            self.ack(
                step, checkpoint_dir=ckpt_dir, signal=sig.value,
                world_size=world_size_of(env), epoch=sig.epoch,
            )
        return sig

    # -- acknowledging --------------------------------------------------------

    def ack(
        self,
        step: Optional[int],
        checkpoint_dir: str = "",
        kind: str = "checkpoint",
        signal: str = "",
        world_size: Optional[int] = None,
        epoch: Optional[int] = None,
        ts: Optional[float] = None,
        digest: Optional[str] = None,
        extra: Optional[Dict] = None,
    ) -> bool:
        """Write this pod's ack file (see :func:`write_checkpoint_ack`);
        ``world_size`` defaults from the current stamped env."""
        if not self.enabled:
            return False
        if world_size is None:
            world_size = world_size_of(self.read_env())
        ok = write_checkpoint_ack(
            self.alloc_spec_dir, self.alloc_hash, step,
            checkpoint_dir=checkpoint_dir, kind=kind, signal=signal,
            world_size=world_size, epoch=epoch, ts=ts, digest=digest,
            extra=extra,
        )
        if ok:
            self.acks_written += 1
        return ok

    def ack_precopy(
        self,
        step: Optional[int],
        round_: int,
        checkpoint_dir: str = "",
        delta_bytes: Optional[int] = None,
        total_bytes: Optional[int] = None,
        digest: Optional[str] = None,
        signal: str = "",
        ts: Optional[float] = None,
    ) -> bool:
        """One pre-copy round's acknowledgement: the delta for ``round_``
        is durable but the workload is still training, so the coordinator
        must not reclaim on it. ``digest`` is the round's chain digest
        from :class:`~.checkpointing.DeltaCheckpointer`."""
        return self.ack(
            step, checkpoint_dir=checkpoint_dir, kind="precopy",
            signal=signal, ts=ts, digest=digest or "",
            extra={
                "round": int(round_),
                **({"delta_bytes": int(delta_bytes)}
                   if delta_bytes is not None else {}),
                **({"total_bytes": int(total_bytes)}
                   if total_bytes is not None else {}),
            },
        )

    def ack_resume(
        self, step: Optional[int], checkpoint_dir: str = "",
        ts: Optional[float] = None,
    ) -> bool:
        """The replacement pod's half of resume verification: written
        after the restore, with the restored step and the world size the
        workload came up at."""
        return self.ack(
            step, checkpoint_dir=checkpoint_dir, kind="resume", ts=ts,
        )


def drain_serving(
    engine,
    watcher: Optional[LifecycleWatcher] = None,
    signal: Optional[Signal] = None,
    max_steps: int = 100_000,
    handoff: bool = False,
) -> dict:
    """Drain a ServingEngine's in-flight requests (serving's answer to a
    drain signal: finishing the live streams is saving the work).

    Runs ``engine.step()`` until no live or pending requests remain, then
    writes a ``kind="drained"`` ack through ``watcher``. Returns a
    summary. ``handoff=True`` publishes the open streams to a shared pool
    for another engine to adopt; the port has no shared pool yet.
    """
    if handoff:
        raise NotImplementedError(
            "drain_serving(handoff=True) publishes streams through a "
            "SharedKVPool: it comes with the shared-pool slice of the port "
            "(prefill/decode roles)"
        )
    drained_tokens = 0
    steps = 0
    while steps < max_steps:
        stats = engine.stats()
        if not stats["live_requests"] and not stats["pending_prefills"]:
            break
        out = engine.step()
        drained_tokens += sum(
            len(v) if isinstance(v, list) else 1 for v in out.values()
        )
        steps += 1
    summary = {
        "steps": steps,
        "drained_tokens": drained_tokens,
        "live_requests": engine.stats()["live_requests"],
        "handoff_streams": 0,
    }
    if watcher is not None and watcher.enabled:
        watcher.ack(
            None, kind="drained",
            signal=signal.value if signal is not None else "",
        )
    return summary
