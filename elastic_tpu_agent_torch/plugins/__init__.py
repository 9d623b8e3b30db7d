"""The agent's device plugins for NVIDIA cards: the counterpart of
``elastic_tpu_agent/plugins/``. ``gpushare`` advertises the
``elasticgpu.io/gpu-core`` and ``gpu-memory`` resources and binds them;
``base`` serves and registers each with the kubelet."""

from .base import DevicePluginServer, PluginConfig
from .gpushare import GPUSharePlugin


def restamp_owner_env(spec_plugin, owner, records, env_updates,
                      remove_keys=()):
    """Restamp env keys into every on-disk spec of one container, under
    the owner's bind stripe: the one post-bind env path (the drain's
    signal and its removal, the pre-copy cutover, the restore stamp), so
    that its writers share the bind's lock and merge semantics
    (``restamp_spec_env_locked`` updates the merged env and the ``own``
    snapshot of every sibling spec). Returns the specs carrying the env
    afterwards. The caller must not hold the stripe (it is not
    reentrant)."""
    from . import gpushare

    with gpushare.bind_lock(owner.pod_key):
        return spec_plugin.restamp_spec_env_locked(
            owner, records, env_updates, remove_keys=remove_keys
        )


__all__ = [
    "DevicePluginServer",
    "PluginConfig",
    "GPUSharePlugin",
    "restamp_owner_env",
]
