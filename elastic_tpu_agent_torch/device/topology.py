"""NVIDIA card table and the host's topology facts.

Counterpart of ``elastic_tpu_agent/tpu/topology.py``. A TPU host names its
slice with an accelerator-type string (``v5litepod-8``) and the table turns
it into per-chip facts; an NVIDIA host names each card by the product name
that ``nvidia-smi`` reports (``NVIDIA H100 80GB HBM3``), and the table
turns that into the facts the agent needs beside the measured ones: the
streaming multiprocessors per card (``cores_per_chip``, the counterpart of
TensorCores), a memory size to fall back on when ``nvidia-smi`` gives none,
and the most cards one host holds.

Sources: NVIDIA's H100 data sheet and Hopper architecture whitepaper (SXM5
and NVL: 132 SMs; PCIe: 114 SMs; 80 GB, 80 GB and 94 GB of HBM). The
fallback sizes are the data sheets' decimal gigabytes, which lie below what
each card reports (an SXM5 card reports 81,559 MiB), so a fallback never
over-advertises memory units.

A GPU host has no slice string of its own: the host's :class:`TopologyInfo`
is built from the cards discovered and the hosts the operator's env lists
(``host_topology``). A slice scheduled across hosts is named by the
``elasticgpu.io/tpu-slice`` annotation in the form ``<family>-<cards>``
(``h100-sxm5-16``: 16 cards of the table's ``h100-sxm5`` family, 8 a host,
so 2 hosts), which :func:`parse_accelerator_type` reads and
:func:`topology_for_hosts` resizes when the slice re-forms. What the
agent stamps from either (``slice_env.py``): ``TPU_WORKER_ID`` and
``TPU_WORKER_HOSTNAMES``, which the port's runner reads
(``workloads/runner.py`` ``slice_layout``), and ``TPU_ACCELERATOR_TYPE``,
the annotation or the card product, verbatim; nothing for a single host
with no slice annotation. The ICI grid bounds the agent derives from a
TPU type have no counterpart on an NVSwitch host and are not stamped.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

MiB = 1024 * 1024
GB = 1000 ** 3


@dataclass(frozen=True)
class ChipSpec:
    """Per-card facts for one NVIDIA product."""

    family: str            # "h100-sxm5", ...
    cores_per_chip: int    # streaming multiprocessors
    hbm_bytes: int         # fallback when nvidia-smi reports no total
    max_chips_per_host: int


# keyed by nvidia-smi's product_name
CHIP_SPECS: Dict[str, ChipSpec] = {
    "NVIDIA H100 80GB HBM3": ChipSpec("h100-sxm5", 132, 80 * GB, 8),
    "NVIDIA H100 PCIe": ChipSpec("h100-pcie", 114, 80 * GB, 8),
    "NVIDIA H100 NVL": ChipSpec("h100-nvl", 132, 94 * GB, 8),
}

# An unknown card: one core, and the smallest memory of any card in the
# table, so that neither resource is over-advertised when nothing better
# is known (tpuvm.py's fallback, for the same reason).
FALLBACK_SPEC = ChipSpec(
    "nvidia", 1, min(s.hbm_bytes for s in CHIP_SPECS.values()),
    max(s.max_chips_per_host for s in CHIP_SPECS.values()),
)


def spec_for_product(product: Optional[str]) -> Optional[ChipSpec]:
    """The table's entry for an nvidia-smi product name; None if unknown."""
    return CHIP_SPECS.get((product or "").strip())


@dataclass(frozen=True)
class TopologyInfo:
    """The fields the agent reads from an operator's ``topology``."""

    accelerator_type: str  # the product name
    spec: ChipSpec
    total_chips: int       # cards across the slice's hosts
    total_cores: int       # SMs across the slice's hosts
    chips_per_host: int
    num_hosts: int

    @property
    def is_multi_host(self) -> bool:
        return self.num_hosts > 1


def host_topology(product: str, chips_per_host: int,
                  num_hosts: int = 1) -> TopologyInfo:
    """Topology of ``num_hosts`` hosts of ``chips_per_host`` cards each;
    an unknown product gets :data:`FALLBACK_SPEC`."""
    spec = spec_for_product(product) or FALLBACK_SPEC
    hosts = max(1, num_hosts)
    total = chips_per_host * hosts
    return TopologyInfo(
        accelerator_type=product,
        spec=spec,
        total_chips=total,
        total_cores=total * spec.cores_per_chip,
        chips_per_host=chips_per_host,
        num_hosts=hosts,
    )


# the card table by family, the first half of a slice type string
_FAMILIES: Dict[str, ChipSpec] = {s.family: s for s in CHIP_SPECS.values()}
_TYPE_RE = re.compile(r"^(?P<family>[a-z0-9-]+?)-(?P<count>\d+)$")


def parse_accelerator_type(acc_type: str) -> Optional[TopologyInfo]:
    """Parse a slice type ``<family>-<cards>`` (``h100-sxm5-16``): the
    family from the card table, the count in cards, at most the family's
    cards a host, so ``h100-sxm5-16`` is 2 hosts of 8. None when the family
    is unknown or the count is not positive. The type string is kept
    verbatim."""
    m = _TYPE_RE.match((acc_type or "").strip().lower())
    if not m:
        return None
    spec = _FAMILIES.get(m.group("family"))
    count = int(m.group("count"))
    if spec is None or count <= 0:
        return None
    per_host = min(count, spec.max_chips_per_host)
    return TopologyInfo(
        accelerator_type=acc_type,
        spec=spec,
        total_chips=count,
        total_cores=count * spec.cores_per_chip,
        chips_per_host=per_host,
        num_hosts=max(1, -(-count // per_host)),
    )


def topology_for_hosts(topo: TopologyInfo, num_hosts: int) -> TopologyInfo:
    """``topo`` resized to ``num_hosts`` hosts, cards a host kept: the shape
    of a slice re-formed at another world size. The type string stays
    verbatim, so that the workload still sees what it was scheduled as."""
    n = max(1, num_hosts)
    return TopologyInfo(
        accelerator_type=topo.accelerator_type,
        spec=topo.spec,
        total_chips=topo.chips_per_host * n,
        total_cores=topo.chips_per_host * n * topo.spec.cores_per_chip,
        chips_per_host=topo.chips_per_host,
        num_hosts=n,
    )
