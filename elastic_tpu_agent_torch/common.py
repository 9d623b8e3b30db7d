"""Constants and small shared helpers of the port's agent side, and its
injectable time source.

The port's copy of what it needs from ``elastic_tpu_agent/common.py``:
the extended resources and their granularity, the scheduler's pod
annotations, the container env contract, the kubelet's file system
contract, ``StripedLockSet`` (its locks only: the agent's wait counters
have no reader here) and ``FileWatcher``; and ``Clock``,
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

import os
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

# -- Container env contract ---------------------------------------------------
# The allocation hash in the container's env, which the injection resolves
# back to the alloc spec ("GPU" is the reference's spelling, also accepted).
EnvAllocationHash = "TPU"
EnvAllocationHashCompat = "GPU"

# Alloc-dir subdirectories of per-allocation sidecar files, each keyed by
# the allocation hash (usage reports, checkpoint acks, flight summaries;
# workloads/contract.py spells them for the in-pod runtime). A released
# allocation's sidecars go with its spec.
AllocSidecarSubdirs = ("usage", "ack", "flight")

# -- Kubelet file system and device-plugin contract (upstream constants) ------
DEVICE_PLUGIN_VERSION = "v1beta1"
DEVICE_PLUGIN_DIR = "/var/lib/kubelet/device-plugins"
KUBELET_SOCKET_NAME = "kubelet.sock"
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
