"""PyTorch/CUDA port of the elastic-tpu-agent workload stack.

``elastic_tpu_agent/`` is the JAX reference and stays as it is; this
package ports it slice by slice, holding each part against the JAX code in
``tests/test_torch_*.py``: the serving slice (forward, KV-cache decode,
the paged ServingEngine), the single-device training slice, and the
in-pod runtime slice (``workloads/runner.py``: the runner's train and
decode modes with the data pipeline, checkpoint/resume, the delta-checkpoint
migration transport, the lifecycle handshake and the flight recorder).
Every Pallas TPU kernel on a ported path is a CUDA kernel written by hand
for Hopper under ``csrc/``, built at first use by ``kernels.py``. The
package imports ``torch`` and never ``jax`` nor the JAX package.
"""
