"""Core value types of the agent side: a device allocation's identity and
a pod's binding records.

The port's copy of ``elastic_tpu_agent/types.py`` (``Device``,
``device_hash``, ``PodContainer``, ``AllocationRecord``, ``PodInfo``),
itself the reference's ``pkg/types/device.go`` and ``pod.go``: a Device is
a *sorted* set of fake-device ids plus the first 8 hex chars of sha256 over
``":".join(ids)``. That hash is the join key of the whole system: it names
the virtual device links under /dev, the env var handed to the container,
and the alloc spec the injection reads. The JSON shapes are the agent's, so
either package's storage reads the other's records.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


def device_hash(ids: Iterable[str]) -> str:
    """First 8 hex chars of sha256 over the sorted, ':'-joined ID set.

    Stable across processes and restarts; collision-safe enough for the
    per-node population of live allocations (reference: device.go:49-54).
    """
    joined = ":".join(sorted(ids))
    return hashlib.sha256(joined.encode("utf-8")).hexdigest()[:8]


@dataclass(frozen=True, eq=False)
class Device:
    """An allocation identity: a sorted fake-device-ID set + resource name.

    ``ids`` are the kubelet-visible fake device IDs (e.g. 100 per card for
    gpu-core, one per MiB for gpu-memory). Two Devices are equal iff their
    sorted ID sets are equal; the resource name is carried metadata and is
    excluded from __eq__/__hash__.
    """

    ids: Tuple[str, ...]
    resource: str = ""

    def __init__(self, ids: Iterable[str], resource: str = "") -> None:
        object.__setattr__(self, "ids", tuple(sorted(ids)))
        object.__setattr__(self, "resource", resource)

    @property
    def hash(self) -> str:
        return device_hash(self.ids)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Device) and self.ids == other.ids

    def __hash__(self) -> int:
        return hash(self.ids)

    def equals(self, other: "Device") -> bool:
        return self.ids == other.ids

    def __len__(self) -> int:
        return len(self.ids)

    def to_dict(self) -> dict:
        return {"ids": list(self.ids), "resource": self.resource}

    @classmethod
    def from_dict(cls, d: dict) -> "Device":
        return cls(d.get("ids", []), d.get("resource", ""))


@dataclass(frozen=True)
class PodContainer:
    """Addresses one container of one pod (reference: pod.go:10-16)."""

    namespace: str
    name: str
    container: str

    @property
    def pod_key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class AllocationRecord:
    """Extra per-container binding state beyond the Device identity.

    The reference persisted only the Device; its GC then had to *guess* how
    many /dev links PreStartContainer created, which leaks links for
    cross-chip core splits (SURVEY.md §7 "known defects"). We persist the
    exact created node IDs and the physical chip indexes so GC and Restore
    are exact.
    """

    device: Device
    chip_indexes: List[int] = field(default_factory=list)
    created_node_ids: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "device": self.device.to_dict(),
            "chip_indexes": list(self.chip_indexes),
            "created_node_ids": list(self.created_node_ids),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AllocationRecord":
        return cls(
            device=Device.from_dict(d["device"]),
            chip_indexes=list(d.get("chip_indexes", [])),
            created_node_ids=list(d.get("created_node_ids", [])),
        )


@dataclass
class PodInfo:
    """Pod binding record: namespace/name + container -> resource -> record.

    JSON-(de)serializable; this is the value stored in the checkpoint store
    (reference: pod.go:24-62 persisted as JSON in BoltDB). Unlike the
    reference's flat container->Device map, allocations are keyed by
    container THEN resource: a container normally holds both a gpu-core and
    a gpu-memory binding, and the reference's flat map let one overwrite
    the other, leaking the loser's /dev links at GC (SURVEY.md §7 defects).
    """

    namespace: str
    name: str
    # container name -> resource name -> record
    allocations: Dict[str, Dict[str, AllocationRecord]] = field(
        default_factory=dict
    )

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def set_allocation(self, container: str, rec: AllocationRecord) -> None:
        self.allocations.setdefault(container, {})[rec.device.resource] = rec

    def device_of(self, container: str, resource: str) -> Optional[Device]:
        rec = self.allocations.get(container, {}).get(resource)
        return rec.device if rec else None

    def records(self) -> Iterator["AllocationRecord"]:
        for by_resource in self.allocations.values():
            yield from by_resource.values()

    def containers(self) -> Iterator[str]:
        return iter(self.allocations)

    def to_json(self) -> str:
        return json.dumps(
            {
                "namespace": self.namespace,
                "name": self.name,
                "allocations": {
                    c: {r: rec.to_dict() for r, rec in by_res.items()}
                    for c, by_res in self.allocations.items()
                },
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, raw: str) -> "PodInfo":
        d = json.loads(raw)
        return cls(
            namespace=d["namespace"],
            name=d["name"],
            allocations={
                c: {
                    r: AllocationRecord.from_dict(rd)
                    for r, rd in by_res.items()
                }
                for c, by_res in d.get("allocations", {}).items()
            },
        )
