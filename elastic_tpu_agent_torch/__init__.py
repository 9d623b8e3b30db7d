"""PyTorch/CUDA port of the elastic-tpu-agent workload stack.

``elastic_tpu_agent/`` is the JAX reference and stays as it is; this
package ports it slice by slice, holding each part against the JAX code in
``tests/test_torch_*.py``. Every Pallas TPU kernel on a ported path is a
CUDA kernel written by hand for Hopper under ``csrc/``, built at first use
by ``kernels.py``. The package imports ``torch`` and never ``jax`` nor the
JAX package.
"""
