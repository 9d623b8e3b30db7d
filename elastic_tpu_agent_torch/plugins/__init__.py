"""The agent's device plugins for NVIDIA cards: the counterpart of
``elastic_tpu_agent/plugins/``. ``gpushare`` advertises the
``elasticgpu.io/gpu-core`` and ``gpu-memory`` resources and binds them;
``base`` serves and registers each with the kubelet."""

from .base import DevicePluginServer, PluginConfig
from .gpushare import GPUSharePlugin

__all__ = [
    "DevicePluginServer",
    "PluginConfig",
    "GPUSharePlugin",
]
