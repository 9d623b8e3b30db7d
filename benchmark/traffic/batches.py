"""Training batches: ``rows`` sequences of ``seq + 1`` token ids (the
targets are the shift by one), uniform over the vocabulary, drawn on the
device from a generator seeded by the run's seed and the step's index,
so that any step's batch can be made again on its own and no two rows
are alike. With ``accum_steps`` > 1 the rows are cut into that many
micro-batches, ``[accum_steps, rows / accum_steps, seq + 1]``.

Parameters (a cell's ``traffic``): ``rows``, ``seq``, ``accum_steps``."""

from __future__ import annotations

from typing import Dict

from ..harness.seeds import derive


def batch(torch, params: Dict, seed: int, step: int, vocab: int, device):
    rows, seq = int(params["rows"]), int(params["seq"])
    accum = int(params.get("accum_steps", 1))
    if rows % accum:
        raise ValueError(f"rows {rows} not a multiple of accum {accum}")
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "batch", step))
    tokens = torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                           device=device)
    return tokens if accum == 1 else tokens.view(accum, rows // accum,
                                                 seq + 1)


def tokens_per_step(params: Dict) -> int:
    return int(params["rows"]) * int(params["seq"])
