"""Slice orchestration of the port's agent side; so far the card packing
(:mod:`packing`). The agent's slice registry and recovery
(``elastic_tpu_agent/slices/``) wait for a later slice."""
