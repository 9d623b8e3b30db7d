"""Multi-host slice env: the worker identity each member pod is stamped with.

Counterpart of ``elastic_tpu_agent/slice_env.py``. Every agent whose node
holds a member of a slice derives the member's env on its own, from its
host facts and the pod's annotations, never from agent-to-agent
coordination, so the derivation must be a pure function of what all of
them read: the hosts' order is a function of the host set.

Env contract (the names the port's runner reads, ``workloads/runner.py``
``slice_layout``, kept from the agent):

  TPU_WORKER_ID          this host's index within the slice
  TPU_WORKER_HOSTNAMES   comma-separated hosts, index-ordered
  TPU_ACCELERATOR_TYPE   the slice annotation's type, or the card product,
                         verbatim

The agent also stamps ``TPU_CHIPS_PER_HOST_BOUNDS`` and ``TPU_HOST_BOUNDS``,
the ICI grid libtpu forms the slice over. Cards on an H100 host are all one
NVSwitch hop apart and hosts meet over the network, so there is no grid to
describe, and nothing in the port reads either key: they are not stamped
(``tests/test_torch_slices.py`` pins this one difference).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .common import (
    AnnotationSliceName,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
)
from .device.topology import TopologyInfo, parse_accelerator_type


def split_hosts(value: str) -> List[str]:
    """The one host-list grammar: comma-separated hostnames, empty entries
    dropped. The annotation parse (registry), the PreStart stamp and the
    stamped-spec parse (recovery) all read it, so that they never disagree
    about one list."""
    return [h for h in (value or "").split(",") if h]


def ordered_worker_hostnames(
    hostnames: List[str], own_host: str = ""
) -> Tuple[List[str], int]:
    """Worker order of an annotation-driven slice: the hosts de-duplicated
    and sorted, and ``own_host``'s index in that order (-1 when absent).

    A pure function of the host set: an order that followed the
    annotation's write order would let two agents disagree about who is
    worker 0, and the slice's rendezvous would hang."""
    ordered = sorted(set(h for h in hostnames if h))
    try:
        own_index = ordered.index(own_host)
    except ValueError:
        own_index = -1
    return ordered, own_index


def slice_env_from_topology(
    topo: TopologyInfo,
    worker_id: int,
    worker_hostnames: List[str],
) -> Dict[str, str]:
    """The slice env of one member (module docstring): no grid bounds."""
    env = {
        "TPU_ACCELERATOR_TYPE": topo.accelerator_type,
        "TPU_WORKER_ID": str(worker_id),
    }
    if worker_hostnames:
        env["TPU_WORKER_HOSTNAMES"] = ",".join(worker_hostnames)
    return env


def slice_env_for_pod(
    annotations: Dict[str, str],
    topo: Optional[TopologyInfo],
    host_worker_id: int = 0,
    host_worker_hostnames: Optional[List[str]] = None,
) -> Dict[str, str]:
    """The slice env of one pod's bind.

    The pod's annotations override the host's facts (a slice scheduled by
    the elastic scheduler carries its own worker numbering); the operator's
    worker id and hosts are the default. No slice annotation and a
    single-host topology: empty (nothing to coordinate)."""
    ann_type = annotations.get(AnnotationSliceName, "")
    ann_id = annotations.get(AnnotationSliceWorkerID, "")
    ann_hosts = annotations.get(AnnotationSliceWorkerHosts, "")

    topo_for_pod = topo
    if ann_type:
        parsed = parse_accelerator_type(ann_type)
        if parsed is not None:
            topo_for_pod = parsed
    if topo_for_pod is None:
        return {}

    worker_id = host_worker_id
    if ann_id:
        try:
            worker_id = int(ann_id)
        except ValueError:
            pass
    hostnames = (split_hosts(ann_hosts) if ann_hosts
                 else list(host_worker_hostnames or []))

    if not topo_for_pod.is_multi_host and not ann_type:
        return {}
    return slice_env_from_topology(topo_for_pod, worker_id, hostnames)
