"""The container injection of a CUDA allocation (the agent's NRI path):
the counterpart of ``elastic_tpu_agent/nri/``. The adjustment an
allocation spec makes and the NRI plugin server (:mod:`plugin`), over the
runtime socket's multiplexer (:mod:`mux`) and ttrpc (:mod:`ttrpc`)."""

from .plugin import (
    NRIPlugin,
    adjustment_from_spec,
    hash_from_env,
    plain_adjustment,
)

__all__ = ["NRIPlugin", "adjustment_from_spec", "hash_from_env",
           "plain_adjustment"]
