"""Constants and small shared helpers of the port's agent side, and its
injectable time source.

The port's copy of what it needs from ``elastic_tpu_agent/common.py``:
the extended resources and their granularity, the scheduler's pod
annotations, the keys of the drain, the migration handshake and the QoS
throttle (node and pod annotations, spec env, alloc-dir sidecars), the
container env
contract, the kubelet's file system
contract, ``StripedLockSet``, ``JitteredBackoff``, ``FileWatcher``, the
process signals of the agent's entry point (``install_dump_signal``,
``wait_for_exit_signal``); and ``Clock``,
``SYSTEM_CLOCK``, ``ManualClock``: production code takes a ``clock``
defaulting to :data:`SYSTEM_CLOCK`; tests hand in a :class:`ManualClock`
and advance it, so "an hour passed" is one method call instead of a
wall-clock wait. The port imports nothing of the JAX package, so it keeps
this copy.

The resources are the GPU ones of the reference (elastic-gpu-agent,
``pkg/plugins/gpushare.go``): ``elasticgpu.io/gpu-core`` in 1% units of a
card, ``elasticgpu.io/gpu-memory`` in MiB. The annotation keys, the alloc
spec's env names and the alloc-dir layout are the agent's, unchanged: the
elastic scheduler and the in-pod runtime speak them whatever the
accelerator.
"""

from __future__ import annotations

import contextlib
import datetime
import faulthandler
import os
import random
import signal
import sys
import threading
import time
import zlib

# -- Extended resources (reference: pkg/plugins/gpushare.go) ------------------
ResourceGPUCore = "elasticgpu.io/gpu-core"
ResourceGPUMemory = "elasticgpu.io/gpu-memory"

# Core-share granularity: 100 units a card, 1% steps (reference
# pkg/common/const.go:4 GPUPercentEachCard).
GPUPercentEachCard = 100

# Memory-share granularity: one unit a MiB of the card's memory (reference
# gpushare.go:161). The elastic scheduler counts in this unit.
BytesPerMemoryUnit = 1024 * 1024

# -- Scheduler contract: pod annotations (reference const.go:5-6) ------------
AnnotationAssumed = "elasticgpu.io/assumed"
AnnotationContainerPrefix = "elasticgpu.io/container-"
# An admission-stamped correlation id a bind's trace adopts
AnnotationTraceID = "elasticgpu.io/trace-id"

# Multi-host slice annotations of the scheduler's contract (names kept):
# the slice's type (``h100-sxm5-16``: device/topology.py), this pod's
# worker id and the comma-separated hosts it indexes.
AnnotationSliceName = "elasticgpu.io/tpu-slice"
AnnotationSliceWorkerID = "elasticgpu.io/tpu-slice-worker-id"
AnnotationSliceWorkerHosts = "elasticgpu.io/tpu-slice-hosts"
# Job-unique slice identity: pods carrying the same id are members of one
# logical slice (slices/registry.py groups membership by it; a draining
# agent annotates its resident members).
AnnotationSliceID = "elasticgpu.io/tpu-slice-id"
# The slice's identity and generation counter in the spec env.
EnvSliceName = "ELASTIC_TPU_SLICE_NAME"
EnvSliceEpoch = "ELASTIC_TPU_SLICE_EPOCH"

# -- Graceful drain and the migration handshake (drain.py, migration.py) ------
# The node annotation that asks this node's agent to cordon and drain;
# removing it cancels.
AnnotationDrain = "elasticgpu.io/drain"
# Stamped by a draining agent on its resident slice-member pods, so that
# the peers' registries count the member as lost before the host goes.
AnnotationDraining = "elasticgpu.io/draining"
# Restamped into resident pods' specs when a drain starts: the trigger
# and the wall-clock deadline (unix seconds) of the binding reclaim.
EnvDrain = "ELASTIC_TPU_DRAIN"
EnvDrainDeadline = "ELASTIC_TPU_DRAIN_DEADLINE"
# Alloc-dir subdirectories of per-allocation sidecar files, each keyed by
# the allocation hash: self-reported utilization ({"ts",
# "duty_cycle_percent"}), checkpoint acks, flight-recorder summaries.
UsageReportSubdir = "usage"
AckSubdir = "ack"
FlightSummarySubdir = "flight"
# One list for the spec reclaim and the reconciler's orphan sweep: a
# released allocation's sidecars go with its spec.
AllocSidecarSubdirs = (UsageReportSubdir, AckSubdir, FlightSummarySubdir)
# Restamped into a replacement pod's specs from a published migration
# record: the checkpoint to resume from, its acked step, and the source
# bind's trace id.
EnvRestoreDir = "ELASTIC_TPU_RESTORE_DIR"
EnvRestoreStep = "ELASTIC_TPU_RESTORE_STEP"
EnvRestoreTrace = "ELASTIC_TPU_RESTORE_TRACE"
# The coordinator's stamp that ends a pre-copy stream: the workload
# pauses, ships the final delta and acks.
EnvCutover = "ELASTIC_TPU_CUTOVER"

# -- QoS enforcement (repartition.py) -----------------------------------------
# Restamped into an overcommitting pod's specs when its quota is clamped:
# the reason, and the wall-clock deadline (unix seconds) of the binding
# reclaim; removed when the throttle lifts.
EnvThrottle = "ELASTIC_TPU_THROTTLE"
EnvThrottleDeadline = "ELASTIC_TPU_THROTTLE_DEADLINE"

# The pod side reads the same keys from workloads/contract.py, which this
# module cannot import (the workloads package imports torch, and the
# agent's process must not); tests hold the two copies equal.

# -- Container env contract ---------------------------------------------------
# The allocation hash in the container's env, which the injection resolves
# back to the alloc spec ("GPU" is the reference's spelling, also accepted).
EnvAllocationHash = "TPU"
EnvAllocationHashCompat = "GPU"

# -- Kubelet file system and device-plugin contract (upstream constants) ------
DEVICE_PLUGIN_VERSION = "v1beta1"
DEVICE_PLUGIN_DIR = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET_NAME = "kubelet.sock"
POD_RESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


class Clock:
    """Wall-clock and monotonic seconds."""

    def time(self) -> float:
        """Wall-clock seconds (``time.time()``)."""
        return time.time()

    def monotonic(self) -> float:
        """Monotonic seconds (``time.monotonic()``)."""
        return time.monotonic()


SYSTEM_CLOCK = Clock()


class ManualClock(Clock):
    """A clock that only moves when told to (tests). Starts at a fixed,
    recognizably fake wall time, so that an un-injected SYSTEM_CLOCK in a
    code path under test shows up as a wildly different timestamp."""

    def __init__(self, start: float = 1_000_000_000.0) -> None:
        self._time = start
        self._monotonic = 0.0

    def time(self) -> float:
        return self._time

    def monotonic(self) -> float:
        return self._monotonic

    def advance(self, seconds: float) -> None:
        self._time += seconds
        self._monotonic += seconds


def container_annotation(container: str) -> str:
    """The annotation holding the card indexes of one container, e.g.
    elasticgpu.io/container-train -> "0,1"."""
    return AnnotationContainerPrefix + container


class StripedLockSet:
    """A fixed array of locks indexed by a stable hash (crc32) of a string
    key: the core and memory PreStarts of one container (one pod key)
    serialize, unrelated pods bind in parallel, and memory stays bounded
    under pod churn."""

    def __init__(self, stripes: int = 64) -> None:
        self._locks = tuple(
            threading.Lock() for _ in range(max(1, stripes))
        )

    def lock_for(self, key: str) -> "threading.Lock":
        return self._locks[zlib.crc32(key.encode("utf-8")) % len(self._locks)]

    def acquire_key(self, key: str) -> float:
        """Block until the stripe of ``key`` is held; returns the seconds
        spent waiting. Pair with :meth:`release_key`."""
        lock = self.lock_for(key)
        if lock.acquire(blocking=False):
            return 0.0
        t0 = time.monotonic()
        lock.acquire()
        return time.monotonic() - t0

    def release_key(self, key: str) -> None:
        self.lock_for(key).release()

    @contextlib.contextmanager
    def acquire(self, key: str):
        """Context-manager form of acquire_key/release_key; yields the
        wait seconds."""
        wait_s = self.acquire_key(key)
        try:
            yield wait_s
        finally:
            self.release_key(key)


class JitteredBackoff:
    """Exponential backoff with 0.5x-1.5x jitter, shared by every retry
    loop (the sitter's list/watch, the supervisor's restarts): one agent a
    node means a dead shared dependency (the apiserver) is hit by every
    node in lockstep without it."""

    def __init__(self, min_s: float, max_s: float, rng=None) -> None:
        self._min = min_s
        self._max = max_s
        self._rng = rng if rng is not None else random.Random()
        self._current = min_s

    def next_delay(self) -> float:
        """The jittered delay to sleep now; doubles the base for next
        time."""
        delay = self._current * (0.5 + self._rng.random())
        self._current = min(self._current * 2, self._max)
        return delay

    def reset(self) -> None:
        self._current = self._min


def install_dump_signal(log_dir: str = "/var/log") -> None:
    """SIGUSR1 -> dump every thread's stack to a timestamped file under
    ``log_dir`` (stderr when it cannot be written)."""

    def _dump(signum, frame):  # noqa: ARG001
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.join(log_dir, f"thread-stacks-{ts}.log")
        try:
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f)
        except OSError:
            faulthandler.dump_traceback(file=sys.stderr)

    signal.signal(signal.SIGUSR1, _dump)


def wait_for_exit_signal() -> int:
    """Block until SIGTERM, SIGINT or SIGQUIT; returns the signal
    number."""
    received: list = []
    ev = threading.Event()

    def _handler(signum, frame):  # noqa: ARG001
        received.append(signum)
        ev.set()

    for s in (signal.SIGTERM, signal.SIGINT, signal.SIGQUIT):
        signal.signal(s, _handler)
    ev.wait()
    return received[0] if received else 0


class FileWatcher:
    """Poll-based watch for a file's creation or replacement (the kubelet
    socket re-created by a kubelet restart), by (st_ino, st_dev,
    st_ctime_ns)."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._sig = self._stat_sig()

    def _stat_sig(self):
        try:
            st = os.stat(self._path)
            return (st.st_ino, st.st_dev, st.st_ctime_ns)
        except OSError:
            return None

    def changed(self) -> bool:
        """True when the file appeared, vanished, or was replaced since the
        last call that returned True (or construction)."""
        sig = self._stat_sig()
        if sig != self._sig:
            self._sig = sig
            return True
        return False


def read_rss_bytes() -> int:
    """This process's resident set size, from ``/proc/self/statm`` (field
    2 is resident pages). Any failure (non-Linux, a locked-down /proc)
    reads as 0, never an exception, so that the
    ``elastic_tpu_agent_rss_bytes`` gauge can carry it unconditionally."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 - a memory gauge must never raise
        return 0
