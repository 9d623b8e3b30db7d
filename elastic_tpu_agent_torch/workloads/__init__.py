"""The ported workload stack: the flagship forward, KV-cache decode and
the paged continuous-batching ServingEngine (forward/serving slice)."""

from .generate import KVCache, generate
from .serving import ServingEngine
from .transformer import ModelConfig, forward, forward_with_aux, init_params
from .weights import params_from_jax, params_to_jax, random_tree

__all__ = [
    "KVCache",
    "ModelConfig",
    "ServingEngine",
    "forward",
    "forward_with_aux",
    "generate",
    "init_params",
    "params_from_jax",
    "params_to_jax",
    "random_tree",
]
