"""The ported workload stack: the flagship forward, the single-device train
step and eval, KV-cache decode and the paged continuous-batching
ServingEngine (forward/serving and training slices), and the in-pod
runtime the agent launches (runtime slice): the runner's train and decode
modes (``runner.py``), the token data pipeline, checkpoint/resume and the
delta-checkpoint migration transport, the lifecycle handshake and the
flight recorder; the Switch-MoE layer and int8 weight-only quantization
(``moe.py``, ``quantize.py``)."""

from .checkpointing import (
    DeltaCheckpointer,
    TrainCheckpointer,
    bytes_to_tree,
    chain_block_digests,
    tree_to_bytes,
)
from .data import TokenDataset, encode_bytes, encode_file, write_token_file
from .generate import KVCache, generate
from .moe import MoeRoutingStats, init_moe_params, moe_mlp
from .quantize import dequantize_params, quantize_params
from .lifecycle import (
    LifecycleWatcher,
    Signal,
    checkpoint_digest,
    drain_serving,
    read_checkpoint_ack,
    write_checkpoint_ack,
)
from .serving import ServingEngine
from .telemetry import (
    FlightRecorder,
    device_memory_stats,
    write_flight_summary,
    write_usage_report,
)
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
    "DeltaCheckpointer",
    "FlightRecorder",
    "KVCache",
    "LifecycleWatcher",
    "ModelConfig",
    "MoeRoutingStats",
    "ServingEngine",
    "Signal",
    "TokenDataset",
    "TrainCheckpointer",
    "bytes_to_tree",
    "chain_block_digests",
    "checkpoint_digest",
    "dequantize_params",
    "device_memory_stats",
    "drain_serving",
    "ema_params",
    "encode_bytes",
    "encode_file",
    "forward",
    "forward_with_aux",
    "generate",
    "init_moe_params",
    "init_params",
    "loss_and_grads",
    "make_eval_fn",
    "make_train_step",
    "moe_mlp",
    "params_from_jax",
    "params_to_jax",
    "quantize_params",
    "random_tree",
    "read_checkpoint_ack",
    "tree_to_bytes",
    "write_checkpoint_ack",
    "write_flight_summary",
    "write_token_file",
    "write_usage_report",
]
