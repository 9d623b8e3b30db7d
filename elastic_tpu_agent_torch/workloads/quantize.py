"""Weight access for the PyTorch port: float leaves only.

Counterpart of ``is_quantized``, ``wdense`` and ``embed_lookup`` in
``elastic_tpu_agent/workloads/quantize.py``. The int8 ``{"q", "s"}`` leaf
form comes with a later slice; meeting one here raises.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _float_leaf(leaf: Any, name: str) -> torch.Tensor:
    if is_quantized(leaf):
        raise NotImplementedError(
            f"int8 weight {name!r}: int8 weights come with a later slice "
            "of the port"
        )
    return leaf


def wdense(container: Dict, name: str, dtype=torch.bfloat16) -> torch.Tensor:
    """A float weight in ``dtype`` (a no-op when stored in it)."""
    return _float_leaf(container[name], name).to(dtype)


def embed_lookup(params: Dict, tokens: torch.Tensor, dtype=torch.bfloat16):
    """Token-embedding gather."""
    return _float_leaf(params["embed"], "embed").to(dtype)[tokens]
