"""Slice orchestration of the port's agent side: card packing, slice
membership and elastic multi-host recovery.

- :mod:`packing`: the card-set picker behind GetPreferredAllocation, the
  canonical card order, and the packing score of a bind.
- :mod:`registry`: SliceRegistry, membership from pod annotations and the
  shared apiserver's pods, the workers' order as a function of the host
  set, and the PreStart slice env with the slice's name and reform epoch.
- :mod:`recovery`: SliceReformer, the reconciler's repair for a slice
  whose membership diverged from its stamp (member loss or return ->
  the survivors re-formed).
"""

from .packing import canonical_chip_order, packing_score, pick_chip_set
from .recovery import SliceReformer
from .registry import SliceMembershipError, SliceRegistry, member_from_pod

__all__ = [
    "SliceMembershipError",
    "SliceReformer",
    "SliceRegistry",
    "canonical_chip_order",
    "member_from_pod",
    "packing_score",
    "pick_chip_set",
]
