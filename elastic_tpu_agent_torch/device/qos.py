"""QoS env: the quota a tenant's allocation carries, and card visibility.

The port's copy of ``elastic_tpu_agent/qos.py`` (the annotation and env
keys, their validation and ``qos_env``), and beside it
:func:`visibility_env`, the NVIDIA counterpart of the agent's
``TPU_VISIBLE_CHIPS``/``TPU_VISIBLE_DEVICES``.

On an NVIDIA card the runtime end of the quota is the port's runner
(``workloads/runner.py`` ``apply_hbm_quota``): ``ELASTIC_TPU_HBM_FRACTION``
caps the tenant's CUDA caching allocator at that fraction of the card
(``torch.cuda.set_per_process_memory_fraction``). The CUDA context, the
cuBLAS workspace and NCCL's buffers lie outside that cap.
``ELASTIC_TPU_CORE_UNITS`` is the tenant's share of the card in 1% units,
a hint: nothing outside the driver time-slices SMs.

Every annotation value is validated and can only shrink the grant: a
malformed one is ignored, never passed through and never a failed bind.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Optional

logger = logging.getLogger(__name__)

AnnotationRepartition = "elasticgpu.io/repartition"
AnnotationQoSPriority = "elasticgpu.io/qos-priority"
AnnotationQoSCoreUnits = "elasticgpu.io/qos-core-units"
AnnotationQoSHBMLimit = "elasticgpu.io/qos-hbm-limit-bytes"

EnvQoSCoreUnits = "ELASTIC_TPU_CORE_UNITS"
EnvQoSHBMLimit = "ELASTIC_TPU_HBM_LIMIT_BYTES"
EnvQoSHBMFraction = "ELASTIC_TPU_HBM_FRACTION"
EnvQoSPriority = "ELASTIC_TPU_PRIORITY"
EnvCUDAVisibleDevices = "CUDA_VISIBLE_DEVICES"

_TRUTHY = ("true", "1", "yes", "enabled")


def _annotation_int(
    annotations: Dict[str, str], key: str
) -> Optional[int]:
    """A positive int annotation value, or None when absent or malformed
    (logged and ignored)."""
    raw = annotations.get(key)
    if raw is None:
        return None
    try:
        value = int(str(raw).strip())
    except (TypeError, ValueError):
        logger.warning(
            "qos: ignoring malformed annotation %s=%r (not an integer)",
            key, raw,
        )
        return None
    if value <= 0:
        logger.warning(
            "qos: ignoring annotation %s=%r (must be a positive integer)",
            key, raw,
        )
        return None
    return value


def _derive_priority(
    annotations: Dict[str, str], pod_spec: Optional[dict] = None
) -> Optional[str]:
    """high|low from the annotation (validated), else from
    priorityClassName, else None (indeterminate)."""
    priority = str(annotations.get(AnnotationQoSPriority, "")).strip().lower()
    if priority in ("high", "low"):
        return priority
    if priority:
        logger.warning(
            "qos: ignoring malformed annotation %s=%r (want high|low)",
            AnnotationQoSPriority, annotations.get(AnnotationQoSPriority),
        )
    if pod_spec:
        pc = (pod_spec.get("spec") or {}).get("priorityClassName", "")
        if pc:
            return "high" if "high" in pc.lower() else "low"
    return None


def pod_priority(
    annotations: Dict[str, str], pod_spec: Optional[dict] = None
) -> str:
    """The pod's QoS priority; indeterminate reads "low"."""
    return _derive_priority(annotations, pod_spec) or "low"


def repartition_opt_in(annotations: Dict[str, str]) -> bool:
    """Whether the pod opted into live re-partitioning; unknown values
    read as opted out."""
    return (
        str(annotations.get(AnnotationRepartition, "")).strip().lower()
        in _TRUTHY
    )


def qos_env(
    annotations: Dict[str, str],
    pod_spec: Optional[dict] = None,
    hbm_limit_bytes: Optional[int] = None,
    chip_hbm_bytes: Optional[int] = None,
    core_units: Optional[int] = None,
) -> Dict[str, str]:
    """The quota env of one allocation: the HBM grant (clamped to the
    card), its fraction of the card, the core units and the priority, each
    annotation override clamped downward."""
    env: Dict[str, str] = {}
    try:
        hbm_limit_bytes = (
            int(hbm_limit_bytes) if hbm_limit_bytes is not None else None
        )
    except (TypeError, ValueError):
        logger.warning(
            "qos: dropping non-numeric hbm_limit_bytes %r", hbm_limit_bytes
        )
        hbm_limit_bytes = None
    if hbm_limit_bytes is not None and hbm_limit_bytes <= 0:
        hbm_limit_bytes = None
    if hbm_limit_bytes and chip_hbm_bytes and hbm_limit_bytes > chip_hbm_bytes:
        logger.warning(
            "qos: HBM quota %d exceeds card memory %d; clamping",
            hbm_limit_bytes, chip_hbm_bytes,
        )
        hbm_limit_bytes = chip_hbm_bytes
    try:
        core_units = int(core_units) if core_units is not None else None
    except (TypeError, ValueError):
        logger.warning("qos: dropping non-numeric core_units %r", core_units)
        core_units = None
    if core_units is not None and core_units < 0:
        logger.warning("qos: dropping negative core_units %d", core_units)
        core_units = None
    ann_hbm = _annotation_int(annotations, AnnotationQoSHBMLimit)
    if ann_hbm is not None and hbm_limit_bytes:
        # without a derived grant there is nothing to cap
        hbm_limit_bytes = min(hbm_limit_bytes, ann_hbm)
    ann_units = _annotation_int(annotations, AnnotationQoSCoreUnits)
    if ann_units is not None and core_units is not None:
        if ann_units > core_units:
            logger.warning(
                "qos: annotation %s=%d exceeds the granted %d core "
                "units; using the grant",
                AnnotationQoSCoreUnits, ann_units, core_units,
            )
        else:
            core_units = ann_units
    if hbm_limit_bytes:
        env[EnvQoSHBMLimit] = str(hbm_limit_bytes)
        if chip_hbm_bytes:
            frac = min(1.0, hbm_limit_bytes / chip_hbm_bytes)
            env[EnvQoSHBMFraction] = f"{frac:.4f}"
    if core_units is not None:
        env[EnvQoSCoreUnits] = str(core_units)
    priority = _derive_priority(annotations, pod_spec)
    if priority:
        env[EnvQoSPriority] = priority
    return env


def visibility_env(chips: Iterable) -> Dict[str, str]:
    """``CUDA_VISIBLE_DEVICES`` naming ``chips`` (GPUChip-like: a
    ``uuid``) by uuid, in the given order. A uuid pins the card whatever
    the process's ``CUDA_DEVICE_ORDER``, whose default (fastest first)
    need not follow nvidia-smi's index. The variable must be set before
    the process's first CUDA call."""
    return {EnvCUDAVisibleDevices: ",".join(c.uuid for c in chips)}
