"""The container injection of a CUDA allocation (the agent's NRI path):
the counterpart of ``elastic_tpu_agent/nri/``. So far the adjustment an
allocation spec makes (:mod:`plugin`); the NRI plugin server waits for a
later slice."""

from .plugin import adjustment_from_spec, hash_from_env, plain_adjustment

__all__ = ["adjustment_from_spec", "hash_from_env", "plain_adjustment"]
