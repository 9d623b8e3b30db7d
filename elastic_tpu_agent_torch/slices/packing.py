"""Card packing for fractional requests, and the canonical card order.

Counterpart of ``elastic_tpu_agent/slices/packing.py``. The agent ranks
chip sets by the ICI hop distance between a TPU host's chips; the cards of
an H100 SXM host are all one NVSwitch hop apart (``device/topology.py``
holds no distance, because there is none to hold), so the policy here is:
the fewest cards that can hold the request; among those, the sets holding
the most cards the request's must-include ids already sit on; then the
lowest indexes. A host has at most a few cards, so the search is
exhaustive.

The packing score (``packing_score``) keeps the agent's metric: the total
pairwise hop count of a bind's card set, exported per bind as the
``elastic_tpu_packing_ici_span`` histogram. Every pair of cards on one host
is one NVSwitch hop, so a set of k cards scores k(k-1)/2.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional


def packing_score(chip_indexes: Iterable[int]) -> int:
    """Total pairwise hop count over a card set: 0 for at most one card,
    k(k-1)/2 for k cards (each pair one NVSwitch hop apart)."""
    k = len(set(chip_indexes))
    return k * (k - 1) // 2


def canonical_chip_order(chip_indexes: Iterable[int]) -> List[int]:
    """The container's card order: ascending index, duplicates dropped.
    ``CUDA_VISIBLE_DEVICES`` lists the bound cards in this order, so the
    same card set gets the same in-container numbering whatever order the
    scheduler's annotation (or a replay) named them in."""
    return sorted(set(chip_indexes))


def pick_chip_set(
    by_chip: Dict[int, List[str]],
    need: int,
    pinned: Optional[set] = None,
) -> List[int]:
    """The cards to draw free fake ids from, in order, for a request of
    ``need`` units: ``by_chip`` maps a card index to its free ids,
    ``pinned`` holds the cards the request's must-include ids sit on.

    The fewest cards whose free ids cover ``need``; among such sets, the
    one with the most pinned cards, then the lowest indexes; pinned cards
    come first in the order, then ascending index. When no set covers
    ``need``, every card in that order (kubelet fails the admission
    itself)."""
    pinned = pinned or set()

    def order(cards):
        return sorted(cards, key=lambda c: (c not in pinned, c))

    total, k = 0, 0
    for free in sorted((len(ids) for ids in by_chip.values()), reverse=True):
        total += free
        k += 1
        if total >= need:
            break
    if total < need:
        return order(by_chip)
    best = None
    for combo in itertools.combinations(sorted(by_chip), k):
        if sum(len(by_chip[c]) for c in combo) < need:
            continue
        key = (-len(pinned.intersection(combo)), combo)
        if best is None or key < best:
            best = key
    return order(best[1])
