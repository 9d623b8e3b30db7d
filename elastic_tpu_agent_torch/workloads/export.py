"""Serving-artifact export, PyTorch port: turn a training checkpoint into a
self-contained directory that a serving process loads without knowing
anything about the training run.

Counterpart of ``elastic_tpu_agent/workloads/export.py``. The JAX
artifact's weights are an orbax ``StandardSave``, which the port can
neither read nor write (it imports no orbax), so the port's artifact is
its own:

    <dir>/config.json         the ModelConfig: byte-equal to the JAX
                              artifact's file for the same config
                              (``json.dump(..., indent=1,
                              sort_keys=True)``, dtype by name)
    <dir>/weights/data.bin    ``checkpointing.tree_to_bytes`` of the params
                              tree: its leaves' raw bytes, in jax.tree
                              flatten order (bf16 as its 2-byte pattern)
    <dir>/weights/index.json  ``checkpointing._index``: [[leaf path, dtype
                              name, shape], ...] in the same order

the framing of one ``TrainCheckpointer`` item, so no third format. Any
tree of tensors fits: the float tree, the int8 weight-only form
(``quantize.quantize_params``, whose ``{"q", "s"}`` leaves index as
``.../q`` int8 and ``.../s`` float32) and a merged-LoRA tree
(``lora.merge_lora``). The index alone rebuilds the tree: list entries
are the numeric path parts.

CLI: convert the latest train checkpoint (the port's ``TrainCheckpointer``
format) in one shot::

    python -m elastic_tpu_agent_torch.workloads.export \\
        --checkpoint-dir /ckpt --preset small --seq 1024 \\
        --out /artifact --int8

``generate``/``ServingEngine`` take ``load_artifact``'s params directly;
the runner's decode mode serves an artifact with ``--params-dir``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .checkpointing import _decode, _flatten, _index, tree_to_bytes
from .transformer import ModelConfig, as_device

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def _cfg_to_json(cfg: ModelConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return d


def _cfg_from_json(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    name = d.pop("dtype")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r} in artifact config")
    return ModelConfig(dtype=_DTYPES[name], **d)


def save_artifact(directory: str, params: Dict, cfg: ModelConfig) -> None:
    """Write a serving artifact. ``params`` may be the float tree, the
    int8 weight-only form or a merged-LoRA tree: any tree of tensors."""
    directory = os.path.abspath(directory)
    weights = os.path.join(directory, "weights")
    os.makedirs(weights, exist_ok=True)
    with open(os.path.join(weights, "data.bin"), "wb") as f:
        f.write(tree_to_bytes(params))
    with open(os.path.join(weights, "index.json"), "w") as f:
        json.dump(_index(params), f)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(_cfg_to_json(cfg), f, indent=1, sort_keys=True)


def _tree_from_index(index, leaves) -> Dict:
    """The nested dicts and lists whose leaf paths ``index`` names, holding
    ``leaves`` in index order (a node whose keys are 0..n-1 is a list)."""
    root: Dict = {}
    for (path, _, _), leaf in zip(index, leaves):
        *parents, name = path.split("/")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def load_artifact(directory: str, device="cuda") -> Tuple[Dict, ModelConfig]:
    """(params, cfg) from a ``save_artifact`` directory, the leaves in
    their stored dtypes on ``device``."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "config.json")) as f:
        cfg = _cfg_from_json(json.load(f))
    weights = os.path.join(directory, "weights")
    with open(os.path.join(weights, "index.json")) as f:
        index = json.load(f)
    data = np.fromfile(os.path.join(weights, "data.bin"), dtype=np.uint8)
    host = _decode(data, [(getattr(torch, e[1]), tuple(e[2])) for e in index])
    device = as_device(device)
    return _tree_from_index(index, [h.to(device) for h in host]), cfg


def tree_bytes(tree) -> int:
    """The bytes of a tree's leaves as stored."""
    return sum(t.numel() * t.element_size() for _, t in _flatten(tree))


def export_checkpoint(
    checkpoint_dir: str,
    out_dir: str,
    cfg: ModelConfig,
    int8: bool = False,
    ema: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Latest train checkpoint -> serving artifact. Returns a summary dict
    (step, int8, ema, bytes, out). ``ema=True`` exports the smoothed
    weights that an ``--ema-decay`` training run saved. LoRA adapters are
    not part of the train checkpoint format: merge them first
    (``lora.merge_lora``) and save the merged tree with ``save_artifact``.
    Raises FileNotFoundError when the directory holds no checkpoint."""
    from .checkpointing import TrainCheckpointer
    from .weights import _tree_map, jax_layout_shapes

    device = as_device(device)
    ckpt = TrainCheckpointer(checkpoint_dir)
    if ckpt.latest_step is None:
        # library API: catchable (main() maps it to an exit message)
        raise FileNotFoundError(
            f"{checkpoint_dir} holds no checkpoint to export"
        )
    # f32 leaves, as the JAX export restores onto init_params
    like = _tree_map(
        lambda path, shape: torch.empty(shape, device=device),
        jax_layout_shapes(cfg),
    )
    params, step = ckpt.restore_params(like, item="ema" if ema else "params")
    ckpt.close()
    if int8:
        from .quantize import quantize_params

        params = quantize_params(params)
    save_artifact(out_dir, params, cfg)
    return {
        "step": step,
        "int8": int8,
        "ema": ema,
        "bytes": tree_bytes(params),
        "out": os.path.abspath(out_dir),
    }


def main(argv=None, device="cuda") -> int:
    import argparse

    from .runner import PRESETS

    parser = argparse.ArgumentParser(
        description="export a train checkpoint as a serving artifact"
    )
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument(
        "--preset", choices=sorted(PRESETS), default="small",
        help="must match the training run's preset",
    )
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--kv-heads", type=int, default=0)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument(
        "--ema", action="store_true",
        help="export the EMA weights (requires an --ema-decay "
             "training run)",
    )
    args = parser.parse_args(argv)

    cfg = ModelConfig(
        max_seq=args.seq, n_kv_heads=args.kv_heads,
        **PRESETS[args.preset],
    )
    try:
        summary = export_checkpoint(
            args.checkpoint_dir, args.out, cfg,
            int8=args.int8, ema=args.ema, device=device,
        )
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
