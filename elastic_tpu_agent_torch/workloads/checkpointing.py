"""Preemption-tolerant checkpoint/resume for the port's workloads, plus the
block-chunked, digest-chained DELTA checkpoints of pre-copy migration.

Counterpart of ``elastic_tpu_agent/workloads/checkpointing.py``, without
orbax:

- :class:`TrainCheckpointer` saves (params, opt_state[, ema]) at a step in
  the port's own on-disk format (one raw byte file and a JSON leaf index
  per item, committed by renaming a temp directory), keeps the newest
  ``keep`` steps and restores onto templates that say where each leaf
  lives. It cannot read the orbax checkpoints the JAX runner writes, and
  the JAX runner cannot read its checkpoints.
- :class:`DeltaCheckpointer` is the pre-copy transport, byte-compatible
  with the JAX copy: the same 256 KiB blocks, blake2b-16 block digests,
  zero chain root, ``manifest-<step>.json`` name and fields, and temp-name
  + rename commits, so the agent's verifier (``migration.py``) accepts a
  chain the port wrote, and either package loads the other's chains.
  Blocks are hashed and written by a pool of ``BLOCK_WORKERS`` threads
  (``hashlib`` releases the interpreter lock on large buffers).
- :func:`tree_to_bytes` / :func:`bytes_to_tree` frame a tree of tensors as
  the JAX functions frame a pytree: leaves in ``jax.tree`` flatten order
  (dict keys sorted, lists and tuples in order, ``None`` dropped), each
  leaf its raw bytes (bf16 as its 2-byte pattern). A params tree therefore
  gives the same bytes in both packages. The port's optimizer state
  (``count``, ``mu``, ``nu``, ``ema``, ``masters``) is not optax's tree, so
  a payload of params plus optimizer state is the port's own.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Delta-checkpoint block size, digest size, chain root and manifest name:
# the JAX package's, so both write and verify the same chains.
DELTA_BLOCK_SIZE = 256 * 1024
_DELTA_DIGEST_SIZE = 16
_DELTA_CHAIN_ROOT = b"\x00" * _DELTA_DIGEST_SIZE
_MANIFEST_PREFIX = "manifest-"
# Workers that hash and write a delta round's blocks: on an H100 host one
# worker hashes blake2b at 0.35-0.54 GB/s, and 8 make a round 2.2-4.6x
# faster (kernel_scan.py's transport readings, PERF.md).
BLOCK_WORKERS = 8


# -- tree framing -------------------------------------------------------------


def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in jax.tree flatten order: dict keys sorted,
    lists and tuples in order, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, path + (i,))]
    return [(path, tree)]


def _rebuild(like, leaves: Dict[Tuple, Any], path: Tuple = ()):
    """A tree shaped like ``like`` (its own key order kept) holding
    ``leaves[path]`` at each leaf."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            _rebuild(v, leaves, path + (i,)) for i, v in enumerate(like)
        )
    return leaves[path]


def _tensor(leaf) -> torch.Tensor:
    return leaf.detach() if isinstance(leaf, torch.Tensor) \
        else torch.as_tensor(np.asarray(leaf))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_to_bytes(tree: Any) -> memoryview:
    """Serialize a tree of tensors (or numpy arrays) into one
    deterministic byte stream, the payload :class:`DeltaCheckpointer`
    chunks. Each leaf is copied once, straight into one host buffer
    (pinned when a leaf lives on the card); returns a memoryview of it."""
    leaves = [_tensor(x) for _, x in _flatten(tree)]
    sizes = [_nbytes(t) for t in leaves]
    on_card = any(t.is_cuda for t in leaves)
    buf = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=on_card)
    off = 0
    for t, n in zip(leaves, sizes):
        if n:
            buf[off:off + n].copy_(
                t.contiguous().reshape(-1).view(torch.uint8), non_blocking=True
            )
        off += n
    if on_card:
        torch.cuda.synchronize()
    return memoryview(buf.numpy())


def _decode(payload, metas: Sequence[Tuple[torch.dtype, Tuple]]) -> List:
    """Host tensors of the given (dtype, shape)s cut in order from
    ``payload``; raises ValueError unless the stream covers them exactly
    (a truncated restore must never zero-fill)."""
    data = np.frombuffer(payload, dtype=np.uint8)
    out, off = [], 0
    for dtype, shape in metas:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        chunk = data[off:off + n]
        if len(chunk) != n:
            raise ValueError(
                f"delta payload truncated: wanted {n} bytes at offset "
                f"{off}, got {len(chunk)}"
            )
        out.append(torch.from_numpy(chunk.copy()).view(dtype).reshape(shape))
        off += n
    if off != len(data):
        raise ValueError(
            f"delta payload has {len(data) - off} trailing bytes beyond "
            "the template"
        )
    return out


def bytes_to_tree(payload, like: Any) -> Any:
    """Inverse of :func:`tree_to_bytes`: rebuild the tree from the byte
    stream with ``like`` as the template of shapes, dtypes and devices.
    Raises ValueError when the stream does not exactly cover it."""
    flat = [(p, _tensor(x)) for p, x in _flatten(like)]
    host = _decode(payload, [(t.dtype, tuple(t.shape)) for _, t in flat])
    return _rebuild(like, {
        p: h.to(t.device) for (p, t), h in zip(flat, host)
    })


# -- full checkpoints ---------------------------------------------------------


def _path_name(path: Tuple) -> str:
    return "/".join(map(str, path))


def _index(tree) -> List:
    """[[leaf path, dtype name, shape], ...] in tree_to_bytes order."""
    return [
        [_path_name(p), str(t.dtype).removeprefix("torch."), list(t.shape)]
        for p, t in ((p, _tensor(x)) for p, x in _flatten(tree))
    ]


class TrainCheckpointer:
    """Save/restore (params, opt_state) at a step, keeping the newest
    ``keep`` steps.

    Layout under ``directory``::

        <step>/<item>/data.bin    tree_to_bytes of the item
        <step>/<item>/index.json  [[leaf path, dtype, shape], ...]

    for the items ``params``, ``opt_state`` and, when saved, ``ema``. A
    save copies every leaf to the host before it returns (the train step
    updates its tensors in place), then a background thread writes the
    step under ``.<step>.tmp`` and renames it into place, so a crash
    leaves the previous steps whole; :meth:`wait` blocks until that commit
    and re-raises its error. The format is the port's own: orbax
    checkpoints from the JAX runner cannot be read here.
    """

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(
        self, step: int, params: Any, opt_state: Any, ema: Any = None,
    ) -> None:
        """``ema``: the EMA tree (transformer.ema_params(opt_state)) as its
        own item, restorable with a plain params template."""
        self.wait()
        items = {"params": params, "opt_state": opt_state}
        if ema is not None:
            items["ema"] = ema
        snapshot = {
            name: (_index(tree), tree_to_bytes(tree))
            for name, tree in items.items()
        }
        self._writer = threading.Thread(
            target=self._commit, args=(int(step), snapshot),
            name=f"checkpoint-{step}", daemon=True,
        )
        self._writer.start()

    def _commit(self, step: int, snapshot: Dict) -> None:
        try:
            tmp = os.path.join(self.directory, f".{step}.tmp")
            shutil.rmtree(tmp, ignore_errors=True)
            for name, (index, data) in snapshot.items():
                item = os.path.join(tmp, name)
                os.makedirs(item)
                with open(os.path.join(item, "data.bin"), "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                with open(os.path.join(item, "index.json"), "w") as f:
                    json.dump(index, f)
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._steps()[:-self.keep]:
                shutil.rmtree(
                    os.path.join(self.directory, str(old)), ignore_errors=True
                )
        except BaseException as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _resolve(self, step: Optional[int]) -> int:
        self.wait()
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError("no checkpoint present")
        return int(step)

    def _read(self, step: int, item: str, like: Any) -> Any:
        d = os.path.join(self.directory, str(step), item)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        flat = [(p, _tensor(x)) for p, x in _flatten(like)]
        want = [[_path_name(p), list(t.shape)] for p, t in flat]
        got = [[e[0], e[2]] for e in index]
        if got != want:
            i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                     min(len(got), len(want)))
            raise ValueError(
                f"checkpoint step {step} item {item!r} does not match the "
                f"template ({len(got)} leaves vs {len(want)}): leaf {i} is "
                f"{got[i] if i < len(got) else None} in the checkpoint, "
                f"{want[i] if i < len(want) else None} in the template"
            )
        data = np.fromfile(os.path.join(d, "data.bin"), dtype=np.uint8)
        host = _decode(data, [
            (getattr(torch, e[1]), tuple(e[2])) for e in index
        ])
        return _rebuild(like, {
            p: h.to(device=t.device, dtype=t.dtype)
            for (p, t), h in zip(flat, host)
        })

    def restore(
        self, params_like: Any, opt_state_like: Any,
        step: Optional[int] = None,
    ) -> Tuple[Any, Any, int]:
        """Restore (params, opt_state, step) onto the templates' devices
        and dtypes; raises ValueError when a template's leaves or shapes
        differ from the checkpoint's."""
        step = self._resolve(step)
        return (
            self._read(step, "params", params_like),
            self._read(step, "opt_state", opt_state_like),
            step,
        )

    def restore_params(
        self, params_like: Any, step: Optional[int] = None,
        item: str = "params",
    ) -> Tuple[Any, int]:
        """Params-only restore for consumers that discard the optimizer
        (decode): the opt_state item is never read. ``item='ema'``
        restores the EMA weights saved by save(..., ema=...)."""
        step = self._resolve(step)
        # item presence is checked up front, so that a real restore
        # failure (wrong preset template, corrupt data) surfaces as itself
        if not os.path.isdir(os.path.join(self.directory, str(step), item)):
            raise FileNotFoundError(
                f"checkpoint step {step} has no {item!r} item"
                + (
                    " (train with --ema-decay to save EMA weights)"
                    if item == "ema" else ""
                )
            )
        return self._read(step, item, params_like), step

    def wait(self) -> None:
        """Block until the save in flight has committed (call before
        exit, and before acknowledging it)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


# -- incremental delta checkpoints (pre-copy transport) -----------------------


def _block_digest(block) -> str:
    return hashlib.blake2b(block, digest_size=_DELTA_DIGEST_SIZE).hexdigest()


def chain_block_digests(digests: List[str]) -> str:
    """The running digest chain over an ordered block-digest list:
    ``chain_j = H(chain_{j-1} || digest_j)``, so the final link identifies
    the whole reassembled state, order included."""
    chain = _DELTA_CHAIN_ROOT
    for d in digests:
        h = hashlib.blake2b(digest_size=_DELTA_DIGEST_SIZE)
        h.update(chain)
        h.update(bytes.fromhex(d))
        chain = h.digest()
    return chain.hex()


class DeltaCheckpointer:
    """Block-chunked, digest-chained delta checkpoints on a shared dir.

    Layout under ``directory``::

        blocks/<digest>.bin     content-addressed block payloads
        manifest-<step>.json    atomic per-round manifest: ordered block
                                digests + the running chain + delta stats

    :meth:`save` chunks the payload, writes only blocks not already
    present (a partial write under a temp name never becomes
    addressable), then commits the manifest with temp-name + rename;
    ``BLOCK_WORKERS`` threads hash and write the blocks. A crash mid-round
    leaves the previous manifest fully restorable; a torn manifest is
    unreadable JSON and skipped by :meth:`latest_step`.
    """

    def __init__(
        self, directory: str, block_size: int = DELTA_BLOCK_SIZE
    ) -> None:
        self.directory = directory
        self.block_size = max(1, int(block_size))
        self._blocks_dir = os.path.join(directory, "blocks")
        # digests of the last manifest committed by this instance: the
        # "since the last snapshot" baseline for delta accounting (an
        # instance resuming over existing state re-reads it lazily)
        self._last_digests: Optional[List[str]] = None

    # -- writing --------------------------------------------------------------

    def _manifest_path(self, step: int) -> str:
        return os.path.join(
            self.directory, f"{_MANIFEST_PREFIX}{int(step):012d}.json"
        )

    def _load_baseline(self) -> List[str]:
        if self._last_digests is not None:
            return self._last_digests
        step = self.latest_step
        if step is None:
            self._last_digests = []
        else:
            m = self.read_manifest(step)
            self._last_digests = list(m.get("blocks", [])) if m else []
        return self._last_digests

    def save(self, step: int, payload, round_: int = 0) -> Dict:
        """Commit one delta round: write changed blocks + the manifest.
        ``payload`` is any bytes-like object (tree_to_bytes' memoryview
        is chunked in place). Returns the round summary (total/delta
        bytes, block counts, the chain digest): what the workload's
        ``kind="precopy"`` ack and the final cutover ack carry."""
        os.makedirs(self._blocks_dir, exist_ok=True)
        prior = set(self._load_baseline())
        view = memoryview(payload).cast("B")
        blocks = [
            view[off:off + self.block_size]
            for off in range(0, max(1, len(view)), self.block_size)
        ]

        def put(block) -> str:
            d = _block_digest(block)
            path = os.path.join(self._blocks_dir, f"{d}.bin")
            if d not in prior and not os.path.exists(path):
                # per-thread temp name: equal blocks may race to one path
                tmp = f"{path}.{threading.get_ident()}.tmp"
                with open(tmp, "wb") as f:
                    f.write(block)
                os.replace(tmp, path)
            return d

        with ThreadPoolExecutor(
            max_workers=min(BLOCK_WORKERS, len(blocks))
        ) as pool:
            digests = list(pool.map(put, blocks))
        changed = [len(b) for b, d in zip(blocks, digests) if d not in prior]
        delta_blocks, delta_bytes = len(changed), sum(changed)
        chain = chain_block_digests(digests)
        manifest = {
            "step": int(step),
            "round": int(round_),
            "block_size": self.block_size,
            "total_bytes": len(view),
            "n_blocks": len(digests),
            "delta_blocks": delta_blocks,
            "delta_bytes": delta_bytes,
            "blocks": digests,
            "chain": chain,
        }
        path = self._manifest_path(step)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)
        self._last_digests = digests
        return {
            "step": int(step),
            "round": int(round_),
            "total_bytes": len(view),
            "delta_bytes": delta_bytes,
            "delta_blocks": delta_blocks,
            "n_blocks": len(digests),
            "chain": chain,
        }

    # -- reading --------------------------------------------------------------

    @property
    def latest_step(self) -> Optional[int]:
        """Highest step with a readable manifest (torn manifests are
        skipped: the previous round stands)."""
        best = None
        try:
            names = os.listdir(self.directory)
        except OSError:
            return None
        for name in names:
            if not (
                name.startswith(_MANIFEST_PREFIX)
                and name.endswith(".json")
            ):
                continue
            try:
                step = int(name[len(_MANIFEST_PREFIX):-len(".json")])
            except ValueError:
                continue
            if (best is None or step > best) and self.read_manifest(
                step
            ) is not None:
                best = step
        return best

    def read_manifest(self, step: int) -> Optional[Dict]:
        try:
            with open(self._manifest_path(step)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return None
        return m if isinstance(m, dict) and "blocks" in m else None

    def verify(self, step: Optional[int] = None) -> Dict:
        """Verify the digest chain of one round's reassembled state: every
        block present, every block's content matching its digest, and the
        recomputed chain equal to the manifest's:
        ``{"ok": bool, "chain": ..., "problems": [...]}``."""
        if step is None:
            step = self.latest_step
        if step is None:
            return {"ok": False, "problems": ["no manifest present"]}
        m = self.read_manifest(step)
        if m is None:
            return {"ok": False, "problems": [f"manifest {step} unreadable"]}
        problems: List[str] = []
        for d in m["blocks"]:
            path = os.path.join(self._blocks_dir, f"{d}.bin")
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                problems.append(f"block {d} missing")
                continue
            if _block_digest(data) != d:
                problems.append(f"block {d} corrupt")
        chain = chain_block_digests(m["blocks"])
        if chain != m.get("chain"):
            problems.append(
                f"chain mismatch: recomputed {chain}, manifest "
                f"{m.get('chain')}"
            )
        return {
            "ok": not problems,
            "step": int(step),
            "chain": chain,
            "n_blocks": len(m["blocks"]),
            "total_bytes": m.get("total_bytes"),
            "problems": problems,
        }

    def load(self, step: Optional[int] = None) -> Tuple[bytes, Dict]:
        """Reassemble one round's full payload, verifying each block and
        the chain on the way (raises ValueError on a torn/corrupt chain:
        the caller falls back, never restores half a state)."""
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError("no delta checkpoint present")
        m = self.read_manifest(step)
        if m is None:
            raise FileNotFoundError(f"delta manifest {step} unreadable")
        parts: List[bytes] = []
        for d in m["blocks"]:
            path = os.path.join(self._blocks_dir, f"{d}.bin")
            with open(path, "rb") as f:
                data = f.read()
            if _block_digest(data) != d:
                raise ValueError(f"delta block {d} corrupt")
            parts.append(data)
        payload = b"".join(parts)[:m["total_bytes"]]
        if chain_block_digests(m["blocks"]) != m.get("chain"):
            raise ValueError("delta digest chain mismatch")
        return payload, m

    def gc(self, keep_steps: int = 2) -> int:
        """Drop manifests beyond the newest ``keep_steps`` and any block
        no surviving manifest references; returns blocks removed.
        Crash-safe: a re-run converges."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        for name in names:
            if name.startswith(_MANIFEST_PREFIX) and name.endswith(".json"):
                try:
                    steps.append(int(name[len(_MANIFEST_PREFIX):-5]))
                except ValueError:
                    continue
        steps.sort()
        live: set = set()
        for s in steps[-max(1, keep_steps):]:
            m = self.read_manifest(s)
            if m:
                live.update(m["blocks"])
        removed = 0
        for s in steps[:-max(1, keep_steps)]:
            try:
                os.unlink(self._manifest_path(s))
            except OSError:
                pass
        try:
            blocks = os.listdir(self._blocks_dir)
        except OSError:
            return 0
        for name in blocks:
            if name.endswith(".bin") and name[:-4] not in live:
                try:
                    os.unlink(os.path.join(self._blocks_dir, name))
                    removed += 1
                except OSError:
                    pass
        return removed
