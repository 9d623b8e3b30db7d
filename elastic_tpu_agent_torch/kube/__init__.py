"""The agent's view of the cluster: the counterpart of
``elastic_tpu_agent/kube/``. ``client`` speaks the apiserver's REST API on
the standard library, ``sitter`` keeps the node's pods and feeds GC their
deletions, ``locator`` finds the container that owns a device set through
the kubelet's pod-resources API."""

from .locator import (
    KubeletDeviceLocator,
    LocateError,
    PodResourcesSnapshotSource,
)
from .sitter import Sitter

__all__ = [
    "KubeletDeviceLocator",
    "LocateError",
    "PodResourcesSnapshotSource",
    "Sitter",
]
