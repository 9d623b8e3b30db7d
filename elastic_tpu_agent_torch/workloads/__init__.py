"""The ported workload stack: the flagship forward, the single-device train
step and eval, KV-cache decode and the paged continuous-batching
ServingEngine (forward/serving and training slices), and the in-pod
runtime the agent launches (runtime slice): the runner's train and decode
modes (``runner.py``), the token data pipeline, checkpoint/resume and the
delta-checkpoint migration transport, the lifecycle handshake and the
flight recorder; the Switch-MoE layer and int8 weight-only quantization
(``moe.py``, ``quantize.py``); the engine's prefix cache
(``prefix_cache.py``), the shared KV pool with prefill/decode roles and
mid-stream handoff, and the request observatory (``request_obs.py``); the
decode variants: speculative decoding, solo (``speculative.py``) and in
the serving engine, beam search (``beam.py``), streaming ring-cache decode
(``streaming.py``) and LoRA adapters (``lora.py``); serving artifacts
(``export.py``), the dp/sp/tp/ep mesh with its split specs, collectives
and ZeRO-1 (``parallel.py``; ``make_train_step``/``make_eval_fn(mesh=)``,
MoE experts over ep with global routing in ``moe.py``), ring attention
over sp (``ring_attention.py``), the GPipe pipeline over pp
(``pipeline.py``), the pipelined flagship with GPipe and 1F1B
(``transformer_pipeline.py``) and sharded decode
(``generate(mesh=)``, ``decode_shardings``); tensor-parallel serving
(``partitioner.py``, ``ServingEngine(mesh=)``), the decode-step traffic
model that resolves the engine's paged-kernel default
(``serving_proxy.py``) and the runner across cards."""

from .beam import beam_search
from .checkpointing import (
    DeltaCheckpointer,
    TrainCheckpointer,
    bytes_to_tree,
    chain_block_digests,
    tree_to_bytes,
)
from .data import TokenDataset, encode_bytes, encode_file, write_token_file
from .export import export_checkpoint, load_artifact, save_artifact
from .generate import KVCache, decode_shardings, generate
from .lora import init_lora_params, make_lora_train_step, merge_lora
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
from .parallel import gather_params, make_mesh, param_shardings, shard_params
from .partitioner import ServingPartitioner, make_serving_mesh
from .pipeline import (
    ProcessGroupPipe,
    StackedPipe,
    make_pipeline_mesh,
    make_pipeline_train_step,
    pipeline_apply,
)
from .prefix_cache import PrefixCache, chain_hashes
# not the ``ring_attention`` function: it would shadow the module
from .ring_attention import ring_attention_sharded, ring_attention_stacked
from .request_obs import RequestObservatory
from .serving import ServingEngine, SharedKVPool, disaggregated_status
from .serving_proxy import decode_step_traffic, recommend_paged_kernel
from .speculative import SpecStats, speculative_generate
from .streaming import streaming_generate
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
from .transformer_pipeline import (
    init_pipeline_params,
    make_pipeline_transformer_step,
    pipeline_1f1b_grads,
)
from .weights import (
    lora_from_jax,
    params_from_jax,
    params_to_jax,
    pipeline_params_from_jax,
    random_tree,
    restack_for_pipeline,
    stage_params_from_jax,
    unstack_pipeline,
)

__all__ = [
    "AdamW",
    "DeltaCheckpointer",
    "FlightRecorder",
    "KVCache",
    "LifecycleWatcher",
    "ModelConfig",
    "MoeRoutingStats",
    "PrefixCache",
    "ProcessGroupPipe",
    "RequestObservatory",
    "ServingEngine",
    "ServingPartitioner",
    "SharedKVPool",
    "Signal",
    "SpecStats",
    "StackedPipe",
    "TokenDataset",
    "TrainCheckpointer",
    "beam_search",
    "bytes_to_tree",
    "chain_block_digests",
    "chain_hashes",
    "checkpoint_digest",
    "decode_shardings",
    "decode_step_traffic",
    "dequantize_params",
    "device_memory_stats",
    "disaggregated_status",
    "drain_serving",
    "ema_params",
    "encode_bytes",
    "encode_file",
    "export_checkpoint",
    "forward",
    "forward_with_aux",
    "gather_params",
    "generate",
    "init_lora_params",
    "init_moe_params",
    "init_params",
    "init_pipeline_params",
    "load_artifact",
    "lora_from_jax",
    "loss_and_grads",
    "make_eval_fn",
    "make_lora_train_step",
    "make_mesh",
    "make_pipeline_mesh",
    "make_pipeline_train_step",
    "make_pipeline_transformer_step",
    "make_serving_mesh",
    "make_train_step",
    "merge_lora",
    "moe_mlp",
    "param_shardings",
    "params_from_jax",
    "params_to_jax",
    "pipeline_1f1b_grads",
    "pipeline_apply",
    "pipeline_params_from_jax",
    "quantize_params",
    "random_tree",
    "read_checkpoint_ack",
    "recommend_paged_kernel",
    "restack_for_pipeline",
    "ring_attention_sharded",
    "ring_attention_stacked",
    "save_artifact",
    "shard_params",
    "speculative_generate",
    "stage_params_from_jax",
    "streaming_generate",
    "tree_to_bytes",
    "unstack_pipeline",
    "write_checkpoint_ack",
    "write_flight_summary",
    "write_token_file",
    "write_usage_report",
]
