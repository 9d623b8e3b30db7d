"""The ported workload stack: the flagship forward, the single-device train
step and eval, KV-cache decode and the paged continuous-batching
ServingEngine (forward/serving and training slices)."""

from .generate import KVCache, generate
from .serving import ServingEngine
from .transformer import (
    AdamW,
    ModelConfig,
    ema_params,
    forward,
    forward_with_aux,
    init_params,
    loss_and_grads,
    make_eval_fn,
    make_train_step,
)
from .weights import params_from_jax, params_to_jax, random_tree

__all__ = [
    "AdamW",
    "KVCache",
    "ModelConfig",
    "ServingEngine",
    "ema_params",
    "forward",
    "forward_with_aux",
    "generate",
    "init_params",
    "loss_and_grads",
    "make_eval_fn",
    "make_train_step",
    "params_from_jax",
    "params_to_jax",
    "random_tree",
]
