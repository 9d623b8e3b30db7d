"""ElasticTPU CRD types and typed client.

The port's copy of ``elastic_tpu_agent/crd.py``. The group, version, kind
and plural stay the agent's (``elasticgpu.io/v1alpha1``, ``ElasticTPU``,
``elastictpus``): the CRD manifest (``deploy/elastic-tpu-crd.yaml``) and
the agent's RBAC serve either agent, and a node's objects read the same
in either. The objects the port writes carry its resource names
(``elasticgpu.io/gpu-core``, ``gpu-memory``) and card indexes. The CRD
surface is optional: the allocation path never depends on it.

A MigrationRecord (migration.py) is an object in phase ``Migrated``
with a ``migration`` payload in its spec and the ``MigrationLabel``, which
a destination agent lists by.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .kube.client import KubeClient, KubeError

GROUP = "elasticgpu.io"
VERSION = "v1alpha1"
PLURAL = "elastictpus"
KIND = "ElasticTPU"
NodeLabel = "elasticgpu.io/node"
# on MigrationRecord objects: the destination's LIST selects by it
MigrationLabel = "elasticgpu.io/migration"

# Canonical phases (reference types.go:49-57).
PhasePending = "Pending"
PhaseAvailable = "Available"
PhaseBound = "Bound"
PhaseReleased = "Released"
PhaseFailed = "Failed"
# a MigrationRecord: the source verified a resident's checkpoint durable
# before reclaiming its cards; the destination deletes it once the resume
# is verified
PhaseMigrated = "Migrated"


@dataclass
class ElasticTPU:
    name: str
    node_name: str = ""
    capacity: Dict[str, str] = field(default_factory=dict)
    chip_indexes: List[int] = field(default_factory=list)
    accelerator_type: str = ""
    claim_namespace: str = ""
    claim_name: str = ""
    claim_container: str = ""
    phase: str = PhasePending
    message: str = ""
    # the MigrationRecord payload (checkpoint location, step, digest,
    # source node, topology env, trace id); None on other objects
    migration: Optional[Dict] = None
    # Server-assigned; must round-trip into updates (a real apiserver
    # rejects RV-less PUTs on custom resources).
    resource_version: str = ""

    def to_manifest(self) -> dict:
        metadata: dict = {"name": self.name}
        if self.resource_version:
            metadata["resourceVersion"] = self.resource_version
        labels: dict = {}
        if self.node_name:
            # Node-scoped label so agents can list with a labelSelector
            # instead of downloading the cluster-wide collection.
            labels[NodeLabel] = self.node_name
        if self.migration is not None:
            labels[MigrationLabel] = "true"
        if labels:
            metadata["labels"] = labels
        spec = {
            "nodeName": self.node_name,
            "capacity": dict(self.capacity),
            "source": {
                "physicalTPU": {"chipIndexes": list(self.chip_indexes)},
                "tpuShare": {
                    "acceleratorType": self.accelerator_type,
                },
            },
            "claimRef": {
                "namespace": self.claim_namespace,
                "name": self.claim_name,
                "container": self.claim_container,
            },
        }
        if self.migration is not None:
            spec["migration"] = dict(self.migration)
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": KIND,
            "metadata": metadata,
            "spec": spec,
            "status": {"phase": self.phase, "message": self.message},
        }

    @classmethod
    def from_manifest(cls, m: dict) -> "ElasticTPU":
        spec = m.get("spec", {}) or {}
        source = spec.get("source", {}) or {}
        claim = spec.get("claimRef", {}) or {}
        status = m.get("status", {}) or {}
        return cls(
            name=m.get("metadata", {}).get("name", ""),
            node_name=spec.get("nodeName", ""),
            capacity=dict(spec.get("capacity", {}) or {}),
            chip_indexes=list(
                (source.get("physicalTPU", {}) or {}).get("chipIndexes", [])
            ),
            accelerator_type=(
                (source.get("tpuShare", {}) or {}).get("acceleratorType", "")
            ),
            claim_namespace=claim.get("namespace", ""),
            claim_name=claim.get("name", ""),
            claim_container=claim.get("container", ""),
            phase=status.get("phase", PhasePending),
            message=status.get("message", ""),
            migration=(
                dict(spec["migration"])
                if isinstance(spec.get("migration"), dict) else None
            ),
            resource_version=m.get("metadata", {}).get("resourceVersion", ""),
        )


class ElasticTPUClient:
    """Typed CRUD over the CRD endpoint (generated-clientset equivalent)."""

    def __init__(self, kube: KubeClient) -> None:
        self._kube = kube
        self._base = f"/apis/{GROUP}/{VERSION}/{PLURAL}"

    def create(self, obj: ElasticTPU, update_existing: bool = True) -> ElasticTPU:
        """Create; on 409 AlreadyExists, update in place by default (the
        agent republishes its chip inventory on every boot).

        The CRD declares the status subresource (deploy/elastic-tpu-crd.yaml),
        so a real apiserver strips ``status`` from main-endpoint writes; the
        requested phase is applied with a second PUT to ``/status``."""
        r = self._kube._post(self._base, obj.to_manifest())
        if r.status_code == 409 and update_existing:
            existing = self.get(obj.name)
            if existing is not None:
                # Updates must carry the server's current resourceVersion.
                obj.resource_version = existing.resource_version
            r = self._kube._put(
                f"{self._base}/{obj.name}", obj.to_manifest()
            )
        if r.status_code not in (200, 201):
            raise KubeError(f"create elastictpu {obj.name}: {r.status_code}")
        created = ElasticTPU.from_manifest(r.json())
        self._put_status(created, obj.phase, obj.message)
        return created

    def _put_status(self, obj: ElasticTPU, phase: str, message: str) -> None:
        """PUT to /status using obj's resourceVersion; obj is refreshed with
        the server's new state on success."""
        obj.phase, obj.message = phase, message
        r = self._kube._put(
            f"{self._base}/{obj.name}/status", obj.to_manifest()
        )
        if r.status_code != 200:
            raise KubeError(
                f"update elastictpu {obj.name} status: {r.status_code}"
            )
        obj.resource_version = (
            r.json().get("metadata", {}).get("resourceVersion", "")
        )

    def get(self, name: str) -> Optional[ElasticTPU]:
        r = self._kube._get(f"{self._base}/{name}")
        if r.status_code == 404:
            return None
        if r.status_code != 200:
            raise KubeError(f"get elastictpu {name}: {r.status_code}")
        return ElasticTPU.from_manifest(r.json())

    def list(self, node_name: str = "") -> List[ElasticTPU]:
        params = (
            {"labelSelector": f"{NodeLabel}={node_name}"} if node_name else None
        )
        r = self._kube._get(self._base, params=params)
        if r.status_code != 200:
            raise KubeError(f"list elastictpus: {r.status_code}")
        items = [
            ElasticTPU.from_manifest(m) for m in r.json().get("items", [])
        ]
        if node_name:
            # Belt-and-braces for objects created before the label existed.
            items = [i for i in items if i.node_name == node_name]
        return items

    def list_migrations(self) -> List[ElasticTPU]:
        """The MigrationRecord objects only (selected by label), so that
        the destination's LIST does not grow with the allocations."""
        r = self._kube._get(
            self._base, params={"labelSelector": f"{MigrationLabel}=true"}
        )
        if r.status_code != 200:
            raise KubeError(f"list migration records: {r.status_code}")
        return [
            ElasticTPU.from_manifest(m) for m in r.json().get("items", [])
        ]

    def delete(self, name: str) -> None:
        r = self._kube._delete(f"{self._base}/{name}")
        if r.status_code not in (200, 404):
            raise KubeError(f"delete elastictpu {name}: {r.status_code}")

    def update_status(self, name: str, phase: str, message: str = "") -> None:
        obj = self.get(name)
        if obj is None:
            raise KubeError(f"elastictpu {name} not found")
        self._put_status(obj, phase, message)
