"""Exclusive (whole-card) operator: no virtual nodes.

Counterpart of ``elastic_tpu_agent/tpu/exclusive.py``: in whole-card mode
the kubelet's device list maps one to one onto physical cards, so
create/delete/check are no-ops, ``virtual_nodes`` is False, and the
agent's plugin hands out each card's ``/dev/nvidia<minor>`` path.
"""

from __future__ import annotations

from typing import List

from .operator import GPUChip, GPUOperator


class ExclusiveOperator(GPUOperator):
    virtual_nodes = False

    def __init__(self, inner: GPUOperator) -> None:
        self._inner = inner

    def devices(self) -> List[GPUChip]:
        return self._inner.devices()

    # defined on the base class, so __getattr__ would not forward them
    def healthy_indexes(self) -> set:
        return self._inner.healthy_indexes()

    def health_reasons(self) -> dict:
        return self._inner.health_reasons()

    def utilization(self) -> dict:
        return self._inner.utilization()

    def error_counters(self) -> dict:
        return self._inner.error_counters()

    def __getattr__(self, name):
        # topology, worker identity, drain triggers and the stub's seams
        return getattr(self._inner, name)

    def create(self, index: int, link_id: str) -> None:  # noqa: ARG002
        return None

    def delete(self, link_id: str) -> None:  # noqa: ARG002
        return None

    def check(self, link_id: str) -> bool:  # noqa: ARG002
        return True
