"""The agent's device layer for NVIDIA hosts: the counterpart of
``elastic_tpu_agent/tpu/`` and ``elastic_tpu_agent/qos.py``.

Operators here fit the agent's duck-typed operator seam
(``ManagerOptions(operator=...)``): ``NvidiaOperator`` discovers cards
through ``/dev/nvidia*`` and ``nvidia-smi``, ``StubOperator`` fakes them,
``ExclusiveOperator`` hands out whole cards. ``qos`` builds the quota env
of an allocation and its ``CUDA_VISIBLE_DEVICES``. Nothing here imports
torch or a CUDA library, so the agent's process holds no CUDA context.
"""

from .exclusive import ExclusiveOperator
from .nvidia import NvidiaOperator
from .operator import GPUChip, GPUOperator, OperatorError
from .stub import StubOperator
from .topology import ChipSpec, TopologyInfo, host_topology

__all__ = [
    "GPUChip",
    "GPUOperator",
    "OperatorError",
    "StubOperator",
    "NvidiaOperator",
    "ExclusiveOperator",
    "ChipSpec",
    "TopologyInfo",
    "host_topology",
]
