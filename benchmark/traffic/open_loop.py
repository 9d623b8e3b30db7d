"""Open-loop arrivals: requests are due on a schedule fixed in advance,
whether or not earlier ones have been served.

Parameters (a cell's ``traffic``): ``rate_per_s``, and ``prompt_len`` and
``output_len``, each ``{"dist": "log_uniform", "min": a, "max": b}``.

Every seed replays the same trace: ``rate_per_s * seconds`` requests due
at the same times with the same prompt and answer lengths, one fixed draw
for the cell's rate and window; the seed draws the token ids (uniform
over the vocabulary), as it draws the weights. The gaps are the
exponential distribution's quantiles at the midpoints of equal strata (a
Poisson process's gaps, stratified), the lengths the log-uniform
distribution's quantiles likewise, each list in an order drawn once. On
the card, seeds that drew their own arrival order, or only their own
order of lengths, spread 19-66% in the tail of time to first token where
reruns of one seed spread a few percent (PERF.md): the order decides
which long prompts queue behind each other, so it is part of the work."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..harness.seeds import derive


def _strata(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = int(spec["min"]), int(spec["max"])
    q = np.exp(math.log(lo) + _strata(n) * math.log(hi / lo))
    return rng.permutation(np.clip(np.rint(q), lo, hi).astype(np.int64))


def schedule(params: Dict, seed: int, seconds: float,
             vocab: int) -> List[Dict]:
    """The window's requests in due order: ``due_s`` after the window's
    start, ``prompt`` (int32 ids), ``output_len``."""
    rate = float(params["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    trace = np.random.default_rng(derive(0, "trace", n))
    due = np.cumsum(trace.permutation(-np.log1p(-_strata(n)) / rate))
    plen = lengths(params["prompt_len"], n, trace)
    olen = lengths(params["output_len"], n, trace)
    rng = np.random.default_rng(derive(seed, "open_loop"))
    return [dict(due_s=float(due[i]),
                 prompt=rng.integers(0, vocab, int(plen[i]), dtype=np.int32),
                 output_len=int(olen[i]))
            for i in range(n) if due[i] < seconds]
