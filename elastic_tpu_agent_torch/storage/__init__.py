"""The agent's checkpoint store: the counterpart of
``elastic_tpu_agent/storage/``."""

from .store import Storage, StorageError

__all__ = ["Storage", "StorageError"]
