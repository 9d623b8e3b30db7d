"""Seeds for every random stream of a run, all derived from ``--seed``.

A stream is named by tags, so that each draw (a layer's weights, a step's
batch, the arrival order) can be made again on its own: the reference
regenerates what it needs from the seed, never from the program."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of run ``seed`` (any whole
    number, also beyond 64 bits)."""
    text = ":".join([str(int(seed)), *map(str, tags)])
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
