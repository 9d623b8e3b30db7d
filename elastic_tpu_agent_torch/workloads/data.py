"""Token data pipeline: memory-mapped datasets with deterministic,
dp-sharded batching.

A numpy-only copy of ``elastic_tpu_agent/workloads/data.py``: the same
file format, the same batch order, so a runner of either package reads
the same batches from one file (``tests/test_torch_runtime.py`` holds the
two byte for byte).

- The file is a flat token stream behind a tiny header, read through
  ``np.memmap``: the page cache is the prefetcher for sequential reads.
- Batching is a pure function of (step, dp_rank, dp_size): every rank
  computes its shard without coordination, and a resumed run reads
  exactly the batches an uninterrupted one would.
- Batches are numpy; the runner copies each to the device.

File format (little-endian): magic ``ETPU``, uint32 version (1), uint32
token dtype itemsize (2 = uint16, 4 = uint32), uint64 token count, then
the raw tokens.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

MAGIC = b"ETPU"
VERSION = 1
_HEADER = struct.Struct("<4sIIQ")


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write a token array (any int dtype; stored uint16 when it fits)."""
    tokens = np.asarray(tokens)
    if tokens.size and tokens.min() < 0:
        raise ValueError("tokens must be non-negative")
    dtype = np.uint16 if (not tokens.size or tokens.max() < 2 ** 16) \
        else np.uint32
    tokens = tokens.astype(dtype)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(
            MAGIC, VERSION, dtype().itemsize, tokens.size
        ))
        tokens.tofile(f)
    os.replace(tmp, path)


def encode_bytes(text: bytes) -> np.ndarray:
    """Hermetic byte-level encoding (vocab 256): no tokenizer needed;
    real deployments bring their own tokenized file."""
    return np.frombuffer(text, dtype=np.uint8).astype(np.uint16)


class TokenDataset:
    """Memory-mapped token stream with deterministic sharded batching."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            raw = f.read(_HEADER.size)
        magic, version, itemsize, count = _HEADER.unpack(raw)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an ETPU token file")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        dtype = {2: np.uint16, 4: np.uint32}.get(itemsize)
        if dtype is None:
            raise ValueError(f"{path}: unsupported token itemsize {itemsize}")
        self.n_tokens = count
        self._tokens = np.memmap(
            path, dtype=dtype, mode="r", offset=_HEADER.size, shape=(count,)
        )

    def max_token(self, sample: "int | None" = None) -> int:
        """Max token id (vocab sanity checks). ``sample`` bounds the scan
        to a prefix; None (default) scans the whole file in chunks: one
        out-of-range token anywhere corrupts training."""
        if self.n_tokens == 0:
            return 0
        end = self.n_tokens if sample is None else min(sample, self.n_tokens)
        out = 0
        chunk = 1 << 24
        for start in range(0, end, chunk):
            out = max(out, int(self._tokens[start: min(start + chunk, end)]
                               .max()))
        return out

    def sequences_per_epoch(self, seq: int) -> int:
        return max(1, (self.n_tokens - 1) // seq)

    def batch(
        self,
        step: int,
        batch: int,
        seq: int,
        dp_rank: int = 0,
        dp_size: int = 1,
        region: "tuple[int, int] | None" = None,
    ) -> np.ndarray:
        """[batch, seq+1] int32 tokens for this rank's shard of ``step``.

        ``batch`` is the local batch; sample k of step t globally is
        ``t*dp_size*batch + dp_rank*batch + k``, striding the stream in
        seq-token windows and wrapping at epoch end (the +1 column is the
        shift-by-one target, overlapping the next window by one token).

        ``region`` = (first_seq, n_seqs) restricts sampling to a
        contiguous range of sequence indices (see split_regions)."""
        if self.n_tokens < seq + 1:
            raise ValueError(
                f"dataset has {self.n_tokens} tokens; need >= {seq + 1}"
            )
        first, n_seqs = region or (0, self.sequences_per_epoch(seq))
        if n_seqs < 1:
            raise ValueError(f"empty region {region}")
        out = np.empty((batch, seq + 1), np.int32)
        base = step * dp_size * batch + dp_rank * batch
        for k in range(batch):
            idx = first + (base + k) % n_seqs
            start = idx * seq
            out[k] = self._tokens[start: start + seq + 1]
        return out

    def split_regions(
        self, seq: int, eval_frac: float
    ) -> "tuple[tuple[int, int], tuple[int, int]]":
        """((train_first, train_n), (eval_first, eval_n)): the last
        max(1, floor(per_epoch * eval_frac)) sequence windows (capped so
        train keeps at least one) are held out, so eval loss measures
        generalization. A file with a single window cannot be split."""
        per_epoch = self.sequences_per_epoch(seq)
        if per_epoch < 2:
            raise ValueError(
                f"dataset has only {per_epoch} sequence window(s) of "
                f"seq={seq}; a held-out split needs at least 2 "
                "(eval on the training window would measure "
                "memorization)"
            )
        n_eval = min(
            max(1, int(per_epoch * eval_frac)), per_epoch - 1
        )
        return (0, per_epoch - n_eval), (per_epoch - n_eval, n_eval)

    def batches(
        self, batch: int, seq: int, dp_rank: int = 0, dp_size: int = 1,
        start_step: int = 0,
    ) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step, batch, seq, dp_rank, dp_size)
            step += 1


def encode_file(input_path: str, output_path: str) -> int:
    """Byte-encode a text/binary file into an ETPU token file; returns
    the token count."""
    with open(input_path, "rb") as f:
        tokens = encode_bytes(f.read())
    write_token_file(output_path, tokens)
    return int(tokens.size)


def main(argv=None) -> int:
    """``python -m elastic_tpu_agent_torch.workloads.data IN OUT``."""
    import argparse

    p = argparse.ArgumentParser(
        description="byte-encode a file into an ETPU token dataset"
    )
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)
    n = encode_file(args.input, args.output)
    print(f"wrote {n} tokens to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
