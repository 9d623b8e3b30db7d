"""Request SLO classes, PyTorch port: the annotation a serving request
carries (``ServingEngine.admit(slo=...)``) and its normalisation, as
``elastic_tpu_agent/workloads/request_obs.py`` defines them. The request
observatory itself comes with a later slice."""

from __future__ import annotations

from typing import Optional

SLO_CLASSES = ("ttft", "tpot", "batch")
DEFAULT_SLO: str = "batch"


def normalize_slo(slo: Optional[str]) -> str:
    """The effective SLO class for any caller-supplied annotation: unknown
    or absent values coerce to the default (the label space is a fixed
    vocabulary, never caller input)."""
    return slo if slo in SLO_CLASSES else DEFAULT_SLO
