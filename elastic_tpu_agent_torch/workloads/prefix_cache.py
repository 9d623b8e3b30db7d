"""Automatic cross-request prefix cache over the serving block pool,
PyTorch port of ``elastic_tpu_agent/workloads/prefix_cache.py`` (host-side
bookkeeping only: numpy and hashlib, no tensors).

Every FULL token block a prefill writes is published under a hash chain
over the block's tokens (hash_j = H(hash_{j-1}, tokens of block j)), and an
admission walks the chain of its prompt to find the longest cached block
prefix. Those blocks are ``share()``d into the new request's table
(refcounted, copy-free) and only the tail is prefilled. A chain rather
than per-block hashes: block j's K/V depend on every token before it, so
"same digest" must mean "same full history".

The digests hash int32 token bytes with 16-byte blake2b, byte for byte as
the JAX module does: the request observatory exports them as
``prefix_digest``, and a gateway may route on them.

Eviction: the cache holds one refcount on every published block; a block
at refcount exactly 1 is held by nobody else and is reclaimable. Under
pool pressure the allocator's reclaim hook evicts least-recently-used such
entries (every lookup hit refreshes recency); blocks a live table or a
registered prefix still maps are never touched.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

# Digest size for the chain keys: 16 bytes of blake2b — collision odds
# are negligible at any realistic cache size, and short keys keep the
# OrderedDict cheap at tens of thousands of entries.
_DIGEST_SIZE = 16
_ROOT = b"\x00" * _DIGEST_SIZE


def chain_hashes(tokens, block_size: int) -> List[bytes]:
    """Hash-chain keys for every FULL block of ``tokens``: entry j keys
    the block holding positions [j*bs, (j+1)*bs) AND its entire token
    history (the parent digest is folded in)."""
    arr = np.asarray(tokens, np.int32).reshape(-1)
    out: List[bytes] = []
    prev = _ROOT
    for j in range(len(arr) // block_size):
        h = hashlib.blake2b(prev, digest_size=_DIGEST_SIZE)
        h.update(arr[j * block_size:(j + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixCache:
    """Block-granular prefix cache over a refcounted BlockAllocator.

    The cache owns ONE reference on each published block (taken via
    ``allocator.share`` at insert, dropped at evict). Request tables
    layer their own refcounts on top, so block lifetime is the max of
    "some request still maps it" and "the cache still remembers it".
    """

    def __init__(
        self,
        allocator,
        block_size: int,
        max_blocks: Optional[int] = None,
    ) -> None:
        self._alloc = allocator
        self.block_size = block_size
        # hard cap on cached blocks (None = bounded only by pool
        # pressure through the allocator's reclaim hook)
        self.max_blocks = max_blocks
        # chain digest -> physical block id; insertion/refresh order IS
        # the LRU order (oldest first)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0            # admissions that reused >= 1 block
        self.misses = 0          # admissions that reused none
        self.evictions = 0       # blocks dropped (pressure or cap)
        self.hit_tokens = 0      # prompt tokens NOT re-prefilled
        self.inserted_blocks = 0

    # -- lookup -------------------------------------------------------

    def lookup(self, tokens) -> Tuple[List[int], int]:
        """Longest cached block-chain prefix of ``tokens``: returns
        (physical block ids, token count covered). Only full blocks
        participate; the walk stops at the first unknown digest. Every
        hit block's entry is refreshed to most-recently-used. Counters
        are NOT touched here — the caller reports the admission's fate
        through record_admission, so a lookup whose admission then
        fails (no free slot, pool exhausted) can't skew the hit
        rate."""
        blocks: List[int] = []
        for digest in chain_hashes(tokens, self.block_size):
            bid = self._entries.get(digest)
            if bid is None:
                break
            self._entries.move_to_end(digest)
            blocks.append(bid)
        return blocks, len(blocks) * self.block_size

    def record_admission(self, covered_tokens: int) -> None:
        """Count one SUCCESSFUL admission against the cache (its slot
        and blocks are claimed): covered > 0 is a hit."""
        if covered_tokens > 0:
            self.hits += 1
            self.hit_tokens += covered_tokens
        else:
            self.misses += 1

    # -- publish ------------------------------------------------------

    def insert(self, tokens, table_blocks) -> int:
        """Publish the full blocks of ``tokens`` (physical ids in
        ``table_blocks``, logical order) into the cache. Blocks whose
        chain digest is already cached are skipped — the existing entry
        keeps serving (and keeps its recency). Returns the number of
        newly published blocks."""
        new = 0
        digests = chain_hashes(tokens, self.block_size)
        for j, digest in enumerate(digests):
            if digest in self._entries:
                continue
            bid = int(table_blocks[j])
            self._alloc.share(bid)
            self._entries[digest] = bid
            self._entries.move_to_end(digest)
            new += 1
            self.inserted_blocks += 1
        if (
            self.max_blocks is not None
            and len(self._entries) > self.max_blocks
        ):
            # best-effort: entries a live table still maps can't be
            # trimmed now; the next insert (or pressure) retries
            self.reclaim(len(self._entries) - self.max_blocks)
        return new

    # -- eviction -----------------------------------------------------

    def reclaim(self, n_blocks: int = 1) -> int:
        """Pool-pressure hook (BlockAllocator.reclaim): free up to
        ``n_blocks`` pool blocks by evicting LRU entries whose block
        the cache is the SOLE holder of (refcount exactly 1); anything
        a live table or registered prefix still maps is skipped.
        Returns how many were actually freed. One ordered scan per
        call — not per block — so a pressure event over a mostly-live
        cache costs O(cache size) once."""
        freed = 0
        for digest in list(self._entries):
            if freed >= n_blocks:
                break
            bid = self._entries[digest]
            if int(self._alloc._ref[bid]) != 1:
                continue  # live in a request's table — never touched
            del self._entries[digest]
            self._alloc.drop(bid)
            self.evictions += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every evictable entry (refcount-1 only); returns the
        count. Entries shared with live tables stay until their
        requests release."""
        return self.reclaim(len(self._entries))

    # -- introspection ------------------------------------------------

    @property
    def cached_blocks(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "cached_blocks": len(self._entries),
            "max_blocks": self.max_blocks,
            "block_size": self.block_size,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "inserted_blocks": self.inserted_blocks,
        }
