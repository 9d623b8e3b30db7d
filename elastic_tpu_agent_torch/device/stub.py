"""Stub operator: N fake H100s for hermetic tests.

Counterpart of ``elastic_tpu_agent/tpu/stub.py``, with its seams: health,
telemetry and drain-trigger injection, the origin stamps of each
injection, and the worker identity of a host in a multi-host slice. Its
cards' minors can be permuted against their indexes (the operator
contract allows it, though ``NvidiaOperator`` makes them equal), so that a
test catches code that takes one for the other.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

from .operator import CONTROL_NODES, GPUChip, LinkingOperator
from .topology import TopologyInfo, host_topology

H100_SXM5 = "NVIDIA H100 80GB HBM3"
# nvidia-smi's total on an H100 SXM5 card
H100_SXM5_HBM_BYTES = 81559 * 1024 * 1024


class StubOperator(LinkingOperator):
    """``num_chips`` fake H100 SXM5 cards, with nvidia-smi's memory total,
    the table's SMs and the host's control nodes; ``minors[i]`` is card
    i's node minor (default i)."""

    def __init__(
        self,
        dev_root: str,
        num_chips: int = 8,
        minors: Optional[Sequence[int]] = None,
        worker_id: int = 0,
        worker_hostnames: Optional[List[str]] = None,
    ) -> None:
        super().__init__(dev_root)
        self._minors = list(minors) if minors is not None \
            else list(range(num_chips))
        if sorted(set(self._minors)) != sorted(self._minors) or \
                len(self._minors) != num_chips:
            raise ValueError(f"minors {self._minors} are not {num_chips} "
                             "distinct numbers")
        self._num = num_chips
        self._worker_hostnames = list(worker_hostnames or [])
        self._topo = host_topology(H100_SXM5, num_chips,
                                   len(self._worker_hostnames))
        self._worker_id = worker_id
        self._unhealthy: set = set()
        self._utilization: dict = {}
        self._maintenance_event = "NONE"
        self._preempted = False
        # when each kind of fault was injected (the agent's latency
        # module reads origin -> detection); ``clock`` may be set to a
        # clock with a ``time()`` method, None uses the wall clock
        self.clock = None
        self._origin_ts: dict = {}

    def _stamp_origin(self, kind: str) -> None:
        self._origin_ts[kind] = (
            self.clock.time() if self.clock is not None else time.time())

    def origin_ts(self, kind: str) -> Optional[float]:
        """When the newest injection of ``kind`` ("maintenance",
        "preempted", "unhealthy", "utilization") happened; None if never."""
        return self._origin_ts.get(kind)

    @property
    def topology(self) -> TopologyInfo:
        return self._topo

    def worker_id(self) -> int:
        return self._worker_id

    def worker_hostnames(self) -> List[str]:
        return list(self._worker_hostnames)

    # -- fault injection ------------------------------------------------------

    def set_unhealthy(self, indexes) -> None:
        if set(indexes) - self._unhealthy:
            self._stamp_origin("unhealthy")
        self._unhealthy = set(indexes)

    def healthy_indexes(self) -> set:
        return {c.index for c in self.devices()} - self._unhealthy

    def set_maintenance_event(self, event: str) -> None:
        """Inject a GCE-style maintenance announcement ("NONE" clears)."""
        if event != "NONE" and event != self._maintenance_event:
            self._stamp_origin("maintenance")
        self._maintenance_event = event

    def maintenance_event(self) -> str:
        return self._maintenance_event

    def set_preempted(self, flag: bool) -> None:
        if flag and not self._preempted:
            self._stamp_origin("preempted")
        self._preempted = bool(flag)

    def preempted(self) -> bool:
        return self._preempted

    # -- telemetry injection --------------------------------------------------

    def set_utilization(self, samples: dict,
                        hbm_used: Optional[dict] = None) -> None:
        """``samples``: card index -> duty-cycle percent; ``hbm_used``:
        card index -> bytes. Cards in neither report no telemetry."""
        hbm_used = hbm_used or {}
        self._utilization = {
            i: {"duty_cycle_percent": float(duty),
                "hbm_used_bytes": int(hbm_used.get(i, 0))}
            for i, duty in samples.items()
        }

    def fail_utilization(self, indexes,
                         reason: str = "injected telemetry failure") -> None:
        self._stamp_origin("utilization")
        for i in indexes:
            self._utilization[i] = {"error": reason}

    def clear_utilization(self) -> None:
        self._utilization = {}

    def utilization(self) -> dict:
        return {i: dict(v) for i, v in self._utilization.items()}

    def devices(self) -> List[GPUChip]:
        spec = self._topo.spec
        return [
            GPUChip(
                uuid=f"GPU-stub-{spec.family}-w{self._worker_id}-{i}",
                index=i,
                device_path=self.node_path(self._minors[i]),
                hbm_bytes=H100_SXM5_HBM_BYTES,
                cores=spec.cores_per_chip,
                extra_paths=[os.path.join(self._target_root, n)
                             for n in CONTROL_NODES],
            )
            for i in range(self._num)
        ]
