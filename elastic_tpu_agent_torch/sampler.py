"""Utilization and health accounting: who is using which card, right now?

The port's copy of ``elastic_tpu_agent/sampler.py``. The agent advertises
fractional resources (gpu-core in percent of a card, gpu-memory in MiB);
this module audits them:

- ``UtilizationSampler`` pulls each card's duty cycle and used memory from
  the operator (``NvidiaOperator.utilization()``: nvidia-smi's
  ``gpu_util`` and framebuffer used; injectable on the stub), joins each
  sample against the allocation store to attribute usage to pods, and
  keeps rolling 1m/5m windows per card and per pod.
- A pod's used core percent is the card's duty split by each pod's share
  of its grant (nvidia-smi gives no per-process duty), unless the pod's
  runtime reports its own: a fresh ``usage/<hash>.json`` under the alloc
  dir (``workloads/telemetry.write_usage_report``) wins, and only the duty
  it did not claim is split among the other pods.
- A pod whose attributed usage stays above its grant by
  ``overcommit_margin`` for ``overcommit_sustain_samples`` samples is an
  **overcommit**: ``elastic_tpu_overcommit_detected_total`` counts one per
  episode, and one JSON log record (``"kind": "tpu_overcommit"``, the log
  contract the agent's pipelines join on, with the bind's trace id) is
  written.
- A card whose telemetry read fails ``unhealthy_after_failures`` times in
  a row is flagged; the plugin's health poll folds the flag in
  (``gpushare.health_once``), so the kubelet sees the card Unhealthy.

The windows and the joined table are served at ``/debug/allocations``
(metrics.py) and in the ``node-doctor`` bundle
(``build_diagnostics_bundle``, ``validate_bundle``), with the repartition
controller's block (repartition.py) and the goodput ledger's replay of the
db (goodput.py). The repartition controller's deltas make a pod's grant
its effective grant (``grant_adjust_fn``). The slice registry's status is
the ``slices`` block (``slice_status_fn``). The agent's serving block comes
with that subsystem.

Like tracing.py this module imports nothing outside the standard library
and is never load-bearing: a sampler failure must not affect binding.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import faults
from .common import (
    BytesPerMemoryUnit,
    FlightSummarySubdir,
    GPUPercentEachCard,
    ResourceGPUCore,
    UsageReportSubdir,
)

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_S = 10.0
# Rolling windows served per card and per pod; the keys are the public
# names of /debug/allocations and the doctor bundle.
WINDOWS = {"1m": 60.0, "5m": 300.0}
# Overcommit: attributed usage above the grant by this many percentage
# points (duty counters jitter) ...
DEFAULT_OVERCOMMIT_MARGIN = 5.0
# ... for this many consecutive samples.
DEFAULT_OVERCOMMIT_SUSTAIN = 3
# Telemetry-read failures in a row before a card is flagged unhealthy.
DEFAULT_UNHEALTHY_AFTER_FAILURES = 3

# Window deques are pruned by horizon on write; the maxlen only guards
# against a clock that never advances.
_MAX_WINDOW_SAMPLES = 720

# How long a pod's self-reported usage file stays fresh; a stale report (a
# wedged or exited workload) falls back to proportional attribution.
USAGE_REPORT_TTL_S = 30.0
USAGE_REPORT_SUBDIR = UsageReportSubdir
# A report stamped in the future (a skewed workload clock) must not stay
# fresh forever.
USAGE_REPORT_FUTURE_SLACK_S = 5.0

# The status blocks of /debug/allocations: (block name, the sampler's
# manager-set hook attribute).
_STATUS_BLOCKS = (
    ("locator", "locator_stats_fn"),
    ("bind", "bind_stats_fn"),
    ("reconcile", "reconcile_status_fn"),
    ("slices", "slice_status_fn"),
    ("drain", "drain_status_fn"),
    ("repartition", "repartition_status_fn"),
    ("migration", "migration_status_fn"),
    ("event_bus", "event_bus_stats_fn"),
)


def _window_stats(samples, horizon_s: float, now: float) -> dict:
    """{"samples", "mean", "max", "last"} over (ts, value) pairs within
    ``horizon_s`` of ``now``."""
    vals = [v for ts, v in samples if now - ts <= horizon_s]
    if not vals:
        return {"samples": 0, "mean": None, "max": None, "last": None}
    return {
        "samples": len(vals),
        "mean": round(sum(vals) / len(vals), 3),
        "max": round(max(vals), 3),
        "last": round(vals[-1], 3),
    }


class UtilizationSampler:
    """Continuous per-card and per-pod utilization accounting."""

    def __init__(
        self,
        operator,
        storage=None,
        metrics=None,
        alloc_spec_dir: Optional[str] = None,
        period_s: float = DEFAULT_PERIOD_S,
        overcommit_margin_percent: float = DEFAULT_OVERCOMMIT_MARGIN,
        overcommit_sustain_samples: int = DEFAULT_OVERCOMMIT_SUSTAIN,
        unhealthy_after_failures: int = DEFAULT_UNHEALTHY_AFTER_FAILURES,
        lag_tracker=None,
        bus=None,
    ) -> None:
        self._operator = operator
        self._storage = storage
        self._metrics = metrics
        self._alloc_spec_dir = alloc_spec_dir
        self.period_s = period_s
        # With an event bus, assignment and bind deltas trigger an early
        # sample, so that the join sees a new or departed tenant at once;
        # the cadence itself stays period_s.
        self._event_sub = None
        if bus is not None:
            from . import events as bus_events

            self._event_sub = bus.subscribe(
                "sampler",
                (bus_events.ASSIGNMENT_DELTA, bus_events.STORE_BIND),
            )
        self.event_samples_total = 0
        self.overcommit_margin = overcommit_margin_percent
        self.overcommit_sustain = max(1, overcommit_sustain_samples)
        self.unhealthy_after = max(1, unhealthy_after_failures)
        # Manager-set status hooks (() -> dict), each one block of
        # /debug/allocations and the doctor bundle (_STATUS_BLOCKS): the
        # locators' caches, the bind pipeline, the reconciler (open
        # intents with their age), the slice registry (each slice's
        # world, epoch, local members, reforms and formation verdict),
        # the drain, the repartition
        # controller, the migration coordinator and the event bus.
        self.locator_stats_fn: Optional[Callable[[], dict]] = None
        self.bind_stats_fn: Optional[Callable[[], dict]] = None
        self.reconcile_status_fn: Optional[Callable[[], dict]] = None
        self.slice_status_fn: Optional[Callable[[], dict]] = None
        self.drain_status_fn: Optional[Callable[[], dict]] = None
        self.repartition_status_fn: Optional[Callable[[], dict]] = None
        self.migration_status_fn: Optional[Callable[[], dict]] = None
        self.event_bus_stats_fn: Optional[Callable[[], dict]] = None
        # Manager-set: (pod_key) -> the signed core-percent delta the
        # repartition controller applies on top of the pod's base grant.
        # The overcommit detector judges usage against the effective
        # grant: otherwise a borrower's growth would trip the very alarm
        # that authorized it.
        self.grant_adjust_fn: Optional[Callable[[str], float]] = None
        # Staleness bound on self-reported usage files (a test seam).
        self.usage_report_ttl_s = USAGE_REPORT_TTL_S
        # Manager-set: (pod_key) -> whether the pod's self-reports are
        # trusted (its repartition opt-in): a pod could otherwise
        # under-report and shift phantom duty onto a co-tenant. None
        # (standalone samplers, tests) accepts every report.
        self.usage_report_allowed_fn: Optional[
            Callable[[str], bool]
        ] = None
        # Manager-set: () -> the plugin's applied set of unhealthy cards.
        # Snapshots read it (a set copy) instead of probing the operator,
        # whose health state the health-poll thread owns.
        self.unhealthy_view_fn: Optional[Callable[[], set]] = None

        self._lock = threading.Lock()
        # card index -> deque[(ts, duty_percent)] / deque[(ts, used bytes)]
        self._chip_duty: Dict[int, deque] = {}
        self._chip_hbm: Dict[int, deque] = {}
        # pod key ("ns/name") -> deque[(ts, used_percent)]
        self._pod_used: Dict[str, deque] = {}
        self._fail_streak: Dict[int, int] = {}
        self._flagged: Dict[int, str] = {}      # card -> unhealthy reason
        self._overcommit_streak: Dict[str, int] = {}
        self._overcommit_active: set = set()
        self._trace_ids: Dict[str, str] = {}    # alloc hash -> trace id
        self._last_pods: Dict[str, dict] = {}   # last join, by pod
        self._last_chips: Dict[int, dict] = {}  # last sample, by card
        self._last_sample_ts: Optional[float] = None
        self.samples_total = 0
        self.overcommit_episodes = 0
        # DetectionLagTracker (latency.py): card flags report lag from the
        # operator's injected telemetry-failure origin, usage reports from
        # the file's own "ts"; each only when the origin is new.
        self._lag = lag_tracker
        self._report_ts: Dict[str, float] = {}  # pod key -> newest "ts"

    # -- the periodic loop ----------------------------------------------------

    def start(self, stop: threading.Event) -> threading.Thread:
        t = threading.Thread(
            target=self.run, args=(stop,), daemon=True, name="gpu-sampler"
        )
        t.start()
        return t

    def run(self, stop: threading.Event) -> None:
        """Sample until ``stop`` (the supervised entry point). With an
        event bus, assignment and bind deltas cut the wait short
        (coalesced behind a short debounce)."""
        while not stop.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampling must never wedge
                logger.exception("utilization sample failed")
            last = time.monotonic()
            sub = self._event_sub
            if sub is None:
                if stop.wait(self.period_s):
                    return
                continue
            trigger = sub.wait_trigger(stop, self.period_s)
            if trigger == "stop":
                return
            if trigger == "event":
                # a burst of bind deltas costs at most one extra sample a
                # min_gap, never one a delta
                min_gap = min(0.5, self.period_s / 4.0)
                gap = min_gap - (time.monotonic() - last)
                if gap > 0 and stop.wait(gap):
                    return
                sub.drain()
                self.event_samples_total += 1

    # -- one sample -----------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> dict:
        """Take one sample; returns the join (also kept for the snapshot
        readers). ``now`` is a test seam."""
        faults.fire("sampler.sample")
        now = time.time() if now is None else now
        try:
            util = self._operator.utilization() or {}
        except Exception as e:  # noqa: BLE001 - backend failure != crash
            logger.warning("operator utilization read failed: %s", e)
            util = {}
        try:
            chips = {c.index: c for c in self._operator.devices()}
        except Exception:  # noqa: BLE001
            chips = {}
        grants = self._join_allocations()
        reports = self._read_usage_reports(grants, now)
        self._read_flight_summaries(grants, now)
        with self._lock:
            self._record_chip_samples(util, chips, now)
            self._attribute_pods(util, grants, now, reports)
            self._last_pods = grants
            self._last_sample_ts = now
            self.samples_total += 1
        self._export_metrics(grants)
        return {"chips": dict(self._last_chips), "pods": grants}

    def _record_chip_samples(self, util: dict, chips: dict,
                             now: float) -> None:
        """(lock held) Fold the backend's samples into the card windows
        and the telemetry-failure streaks."""
        self._last_chips = {}
        for idx in chips:
            entry = util.get(idx)
            if entry is None:
                # no telemetry for this card: never flag on absence, and
                # release a standing flag (a driver reload that removes
                # the reading must not leave the card Unhealthy)
                self._fail_streak.pop(idx, None)
                if self._flagged.pop(idx, None) is not None:
                    logger.info(
                        "card %d: telemetry gone; clearing sampler "
                        "health flag", idx,
                    )
                continue
            if entry.get("error"):
                streak = self._fail_streak.get(idx, 0) + 1
                self._fail_streak[idx] = streak
                if streak >= self.unhealthy_after and idx not in self._flagged:
                    reason = (
                        f"utilization telemetry failing "
                        f"({streak} consecutive samples): {entry['error']}"
                    )
                    self._flagged[idx] = reason
                    logger.warning("card %d: %s", idx, reason)
                    if self._lag is not None:
                        origin = None
                        fn = getattr(self._operator, "origin_ts", None)
                        if fn is not None:
                            try:
                                origin = fn("utilization")
                            except Exception:  # noqa: BLE001
                                origin = None
                        # flagging is the sampler's repair: the plugin
                        # acts on the flag
                        self._lag.handled(
                            "sampler", "chip_unhealthy", key=str(idx),
                            origin_ts=origin,
                        )
                self._last_chips[idx] = {"error": entry["error"]}
                continue
            if self._fail_streak.pop(idx, 0) and idx in self._flagged:
                logger.info("card %d: utilization telemetry recovered", idx)
            self._flagged.pop(idx, None)
            duty = float(entry.get("duty_cycle_percent", 0.0))
            hbm = int(entry.get("hbm_used_bytes", 0))
            self._chip_duty.setdefault(
                idx, deque(maxlen=_MAX_WINDOW_SAMPLES)
            ).append((now, duty))
            self._chip_hbm.setdefault(
                idx, deque(maxlen=_MAX_WINDOW_SAMPLES)
            ).append((now, hbm))
            self._prune(self._chip_duty[idx], now)
            self._prune(self._chip_hbm[idx], now)
            self._last_chips[idx] = {
                "duty_cycle_percent": duty, "hbm_used_bytes": hbm,
            }

    @staticmethod
    def _prune(samples: deque, now: float) -> None:
        horizon = max(WINDOWS.values())
        while samples and now - samples[0][0] > horizon:
            samples.popleft()

    # -- allocation join ------------------------------------------------------

    def _join_allocations(self) -> Dict[str, dict]:
        """The allocation store as pod key -> {containers, chips: {card:
        core grant %}, granted_percent, hbm_granted_bytes, resources,
        hashes, last_trace_id}."""
        out: Dict[str, dict] = {}
        if self._storage is None:
            return out
        whole_chip = not getattr(self._operator, "virtual_nodes", True)
        try:
            items = list(self._storage.items())
        except Exception:  # noqa: BLE001 - storage trouble is not ours
            logger.exception("sampler: allocation-store snapshot failed")
            return out
        for key, info in items:
            pod = out.setdefault(key, {
                "containers": [], "chips": {}, "granted_percent": 0.0,
                "hbm_granted_bytes": 0, "resources": [], "hashes": [],
                "last_trace_id": "",
            })
            for container, by_resource in info.allocations.items():
                if container not in pod["containers"]:
                    pod["containers"].append(container)
                for resource, rec in by_resource.items():
                    if resource not in pod["resources"]:
                        pod["resources"].append(resource)
                    pod["hashes"].append(rec.device.hash)
                    trace_id = self._trace_id_for(rec.device.hash)
                    if trace_id:
                        pod["last_trace_id"] = trace_id
                    if resource == ResourceGPUCore:
                        if whole_chip:
                            granted = GPUPercentEachCard * max(
                                1, len(rec.chip_indexes)
                            )
                        else:
                            granted = float(len(rec.device.ids))
                        pod["granted_percent"] += granted
                        n = max(1, len(rec.chip_indexes))
                        for chip in rec.chip_indexes:
                            pod["chips"][chip] = (
                                pod["chips"].get(chip, 0.0) + granted / n
                            )
                    else:
                        pod["hbm_granted_bytes"] += (
                            len(rec.device.ids) * BytesPerMemoryUnit
                        )
                        for chip in rec.chip_indexes:
                            pod["chips"].setdefault(chip, 0.0)
        return out

    def _trace_id_for(self, alloc_hash: str) -> str:
        """The trace id of the bind that made this allocation, read once
        from its spec env (the id of its /debug/traces entry and its
        TPUBound Event)."""
        if alloc_hash in self._trace_ids:
            return self._trace_ids[alloc_hash]
        trace_id = ""
        if self._alloc_spec_dir:
            path = os.path.join(self._alloc_spec_dir, f"{alloc_hash}.json")
            try:
                with open(path) as f:
                    spec = json.load(f)
                trace_id = str(
                    spec.get("env", {}).get("ELASTIC_TPU_TRACE_ID", "")
                )
            except (OSError, ValueError):
                return ""  # spec not written yet (bind in flight): retry
        self._trace_ids[alloc_hash] = trace_id
        return trace_id

    def _fresh(self, ts: float, now: float) -> bool:
        return not (now - ts > self.usage_report_ttl_s
                    or ts - now > USAGE_REPORT_FUTURE_SLACK_S)

    def _read_usage_reports(
        self, grants: Dict[str, dict], now: float
    ) -> Dict[str, float]:
        """pod key -> self-reported duty percent, for pods with a fresh
        ``usage/<hash>.json``; a malformed or stale file falls back to
        proportional attribution. Read outside the sampler lock."""
        out: Dict[str, float] = {}
        if not self._alloc_spec_dir:
            return out
        usage_dir = os.path.join(self._alloc_spec_dir, USAGE_REPORT_SUBDIR)
        if not os.path.isdir(usage_dir):
            return out
        for key, pod in grants.items():
            if self.usage_report_allowed_fn is not None:
                try:
                    if not self.usage_report_allowed_fn(key):
                        continue  # not opted in: report untrusted
                except Exception:  # noqa: BLE001 - fail closed
                    continue
            best_ts = None
            best_duty = None
            for alloc_hash in pod["hashes"]:
                path = os.path.join(usage_dir, f"{alloc_hash}.json")
                try:
                    with open(path) as f:
                        report = json.load(f)
                    ts = float(report["ts"])
                    duty = float(report["duty_cycle_percent"])
                except (OSError, ValueError, KeyError, TypeError):
                    continue
                if not self._fresh(ts, now) or duty < 0:
                    continue
                if best_ts is None or ts > best_ts:
                    best_ts, best_duty = ts, duty
            if best_duty is not None:
                out[key] = best_duty
                if (
                    self._lag is not None
                    and best_ts > self._report_ts.get(key, float("-inf"))
                ):
                    # only a strictly newer report is a new event
                    self._report_ts[key] = best_ts
                    self._lag.handled(
                        "sampler", "usage_report", key=key,
                        origin_ts=best_ts,
                    )
        return out

    def _read_flight_summaries(
        self, grants: Dict[str, dict], now: float
    ) -> None:
        """Fold fresh flight-recorder summaries (``flight/<hash>.json``,
        written by ``telemetry.write_flight_summary``) into the join: the
        pod's achieved tokens/s (and a serving pod's TTFT p50) for
        /debug/allocations and the gauges. Display only, so no trust
        gate; the usage reports' staleness rules."""
        if not self._alloc_spec_dir:
            return
        flight_dir = os.path.join(self._alloc_spec_dir, FlightSummarySubdir)
        if not os.path.isdir(flight_dir):
            return
        for pod in grants.values():
            best_ts = None
            best = None
            best_ttft = None
            for alloc_hash in pod["hashes"]:
                path = os.path.join(flight_dir, f"{alloc_hash}.json")
                try:
                    with open(path) as f:
                        summary = json.load(f)
                    ts = float(summary["ts"])
                    rate = float(summary["tokens_per_s"])
                except (OSError, ValueError, KeyError, TypeError):
                    continue
                if not self._fresh(ts, now) or rate < 0:
                    continue
                if best_ts is None or ts > best_ts:
                    best_ts, best = ts, rate
                    ttft = summary.get("ttft_p50_s")
                    try:
                        best_ttft = (
                            float(ttft)
                            if ttft is not None and float(ttft) >= 0
                            else None
                        )
                    except (ValueError, TypeError):
                        best_ttft = None
            if best is not None:
                pod["tokens_per_s"] = best
                if best_ttft is not None:
                    pod["ttft_p50_s"] = best_ttft

    # -- attribution and overcommit -------------------------------------------

    def _attribute_pods(
        self, util: dict, grants: dict, now: float,
        reports: Optional[Dict[str, float]] = None,
    ) -> None:
        """(lock held) Attribute each card's duty to its pods: a fresh
        self-report as it stands, the remaining duty split among the other
        pods by their share of the grant; then the overcommit detector."""
        reports = reports or {}
        chip_total_grant: Dict[int, float] = {}
        pod_total_share: Dict[str, float] = {}
        for key, pod in grants.items():
            pod_total_share[key] = sum(pod["chips"].values())
            if key in reports:
                continue  # reporters don't compete for the remainder
            for chip, share in pod["chips"].items():
                chip_total_grant[chip] = (
                    chip_total_grant.get(chip, 0.0) + share
                )
        # reported duty pinned to cards (a multi-card reporter's split by
        # its own grant shares), so that the non-reporters divide what
        # the reporters did not claim
        reported_chip_duty: Dict[int, float] = {}
        for key, duty in reports.items():
            pod = grants.get(key)
            if pod is None or not pod["chips"]:
                continue
            own_total = pod_total_share.get(key, 0.0)
            for chip, share in pod["chips"].items():
                frac = (
                    share / own_total if own_total > 0
                    else 1.0 / len(pod["chips"])
                )
                reported_chip_duty[chip] = (
                    reported_chip_duty.get(chip, 0.0) + duty * frac
                )
        for key, pod in grants.items():
            used = 0.0
            covered = False
            if key in reports:
                used = reports[key]
                covered = True
                pod["self_reported"] = True
            else:
                for chip, share in pod["chips"].items():
                    sample = self._last_chips.get(chip)
                    if not sample or "duty_cycle_percent" not in sample:
                        continue
                    covered = True
                    duty = max(
                        0.0,
                        sample["duty_cycle_percent"]
                        - reported_chip_duty.get(chip, 0.0),
                    )
                    total = chip_total_grant.get(chip, 0.0)
                    if total > 0:
                        used += duty * (share / total)
                    elif len(
                        [p for p in grants.values() if chip in p["chips"]]
                    ) == 1:
                        used += duty  # a memory-only sole tenant
            pod["used_percent"] = round(used, 3) if covered else None
            pod["granted_percent"] = round(pod["granted_percent"], 3)
            if covered:
                self._pod_used.setdefault(
                    key, deque(maxlen=_MAX_WINDOW_SAMPLES)
                ).append((now, used))
                self._prune(self._pod_used[key], now)
                self._detect_overcommit(key, pod, used, now)
            else:
                # no current evidence: stop asserting overcommit rather
                # than freeze a stale flag
                self._overcommit_streak.pop(key, None)
                if key in self._overcommit_active:
                    self._overcommit_active.discard(key)
                    logger.info(
                        "pod %s: card telemetry lost; clearing "
                        "overcommit flag", key,
                    )
            pod["overcommit"] = key in self._overcommit_active
        # pods that left the store: windows, streaks, metric series
        for gone in set(self._pod_used) - set(grants):
            self._pod_used.pop(gone, None)
            self._overcommit_streak.pop(gone, None)
            self._overcommit_active.discard(gone)
            self._drop_pod_series(gone)
        live_hashes = {
            h for pod in grants.values() for h in pod["hashes"]
        }
        for stale in set(self._trace_ids) - live_hashes:
            del self._trace_ids[stale]

    def _detect_overcommit(
        self, key: str, pod: dict, used: float, now: float
    ) -> None:
        granted = pod["granted_percent"]
        if self.grant_adjust_fn is not None:
            # the controller's grow or shrink on top of the base grant
            try:
                adjust = float(self.grant_adjust_fn(key))
            except Exception:  # noqa: BLE001 - never load-bearing
                adjust = 0.0
            if adjust:
                granted = max(0.0, granted + adjust)
                pod["effective_granted_percent"] = round(granted, 3)
        if granted <= 0 or used <= granted + self.overcommit_margin:
            self._overcommit_streak[key] = 0
            if key in self._overcommit_active:
                self._overcommit_active.discard(key)
                logger.info(
                    "pod %s back within its core grant "
                    "(used %.1f%% of %.1f%%)", key, used, granted,
                )
            return
        streak = self._overcommit_streak.get(key, 0) + 1
        self._overcommit_streak[key] = streak
        if streak < self.overcommit_sustain or key in self._overcommit_active:
            return
        self._overcommit_active.add(key)
        self.overcommit_episodes += 1
        if self._metrics is not None:
            self._metrics.overcommit_detected.inc()
        # a structured record, which log pipelines join with /debug/traces
        # on trace_id; the kind string is the agent's
        logger.warning("%s", json.dumps({
            "kind": "tpu_overcommit",
            "ts": now,
            "pod": key,
            "granted_core_percent": granted,
            "used_core_percent": round(used, 3),
            "chips": sorted(pod["chips"]),
            "sustained_samples": streak,
            "trace_id": pod.get("last_trace_id", ""),
        }, sort_keys=True))

    # -- metrics export -------------------------------------------------------

    def _export_metrics(self, grants: dict) -> None:
        m = self._metrics
        if m is None:
            return
        try:
            for idx, sample in self._last_chips.items():
                if "duty_cycle_percent" in sample:
                    m.chip_duty_cycle.labels(chip=str(idx)).set(
                        sample["duty_cycle_percent"]
                    )
                    m.chip_hbm_used.labels(chip=str(idx)).set(
                        sample["hbm_used_bytes"]
                    )
            for key, pod in grants.items():
                m.pod_core_granted.set(pod["granted_percent"], pod=key)
                if pod.get("used_percent") is not None:
                    m.pod_core_used.set(pod["used_percent"], pod=key)
                # without a fresh summary this sample the series goes,
                # rather than freeze a dead workload's last reading
                for field, gauge in (("tokens_per_s", m.workload_tokens_per_s),
                                     ("ttft_p50_s", m.workload_ttft)):
                    if pod.get(field) is not None:
                        gauge.set(pod[field], pod=key)
                    else:
                        gauge.remove(pod=key)
        except Exception:  # noqa: BLE001 - metrics must never break sampling
            logger.exception("sampler metrics export failed")

    def _drop_pod_series(self, key: str) -> None:
        m = self._metrics
        if m is None:
            return
        for gauge in (m.pod_core_granted, m.pod_core_used,
                      m.workload_tokens_per_s, m.workload_ttft):
            try:
                gauge.remove(pod=key)
            except Exception:  # noqa: BLE001 - an absent series is fine
                pass

    # -- health view (read by gpushare.health_once) ---------------------------

    def unhealthy_chips(self) -> set:
        """Cards the sampler flags (telemetry failing)."""
        with self._lock:
            return set(self._flagged)

    def health_reasons(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._flagged)

    # -- read surfaces --------------------------------------------------------

    @property
    def last_sample_ts(self) -> Optional[float]:
        with self._lock:
            return self._last_sample_ts

    def chip_windows(self, now: Optional[float] = None) -> Dict[int, dict]:
        """card -> {"1m": stats, "5m": stats} over duty, plus "hbm"."""
        now = time.time() if now is None else now
        with self._lock:
            out = {}
            for idx, samples in self._chip_duty.items():
                out[idx] = {
                    name: _window_stats(samples, horizon, now)
                    for name, horizon in WINDOWS.items()
                }
                hbm = self._chip_hbm.get(idx)
                if hbm:
                    out[idx]["hbm"] = {
                        name: _window_stats(hbm, horizon, now)
                        for name, horizon in WINDOWS.items()
                    }
            return out

    def utilization_view(self) -> dict:
        """Copies of the last join: ``pods`` (pod -> chips, granted, used,
        self_reported, overcommit), ``chips`` (card -> last sample) and
        the sample's time. Safe from any thread; never blocks on a
        sample."""
        with self._lock:
            return {
                "pods": {
                    k: {**v, "chips": dict(v["chips"])}
                    for k, v in self._last_pods.items()
                },
                "chips": {k: dict(v) for k, v in self._last_chips.items()},
                "ts": self._last_sample_ts,
            }

    def pod_windows(self, now: Optional[float] = None) -> Dict[str, dict]:
        now = time.time() if now is None else now
        with self._lock:
            return {
                key: {
                    name: _window_stats(samples, horizon, now)
                    for name, horizon in WINDOWS.items()
                }
                for key, samples in self._pod_used.items()
            }

    def allocations_snapshot(self) -> dict:
        """The live card -> pod table of /debug/allocations and the
        node-doctor bundle."""
        try:
            devices = self._operator.devices()
        except Exception:  # noqa: BLE001
            devices = []
        healthy = None
        if self.unhealthy_view_fn is not None:
            # a live agent: the plugin's applied view (it already holds
            # this sampler's flags)
            try:
                healthy = (
                    {c.index for c in devices} - self.unhealthy_view_fn()
                )
            except Exception:  # noqa: BLE001
                healthy = None
        if healthy is None:
            # standalone (node-doctor without an agent): probe the
            # operator, single-threaded there
            try:
                healthy = set(self._operator.healthy_indexes())
            except Exception:  # noqa: BLE001
                healthy = set()
        try:
            op_reasons = dict(self._operator.health_reasons())
        except Exception:  # noqa: BLE001
            op_reasons = {}
        # windows relative to the last sample's clock, so that a snapshot
        # long after sampling stopped still shows the final windows
        with self._lock:
            snapshot_now = self._last_sample_ts
        pod_windows = self.pod_windows(now=snapshot_now)
        with self._lock:
            flagged = dict(self._flagged)
            pods = {k: dict(v) for k, v in self._last_pods.items()}
            chips_last = {k: dict(v) for k, v in self._last_chips.items()}
            last_ts = self._last_sample_ts
            samples_total = self.samples_total
        chip_rows: List[dict] = []
        for chip in devices:
            idx = chip.index
            reason = flagged.get(idx) or op_reasons.get(idx)
            bound = sorted(k for k, p in pods.items() if idx in p["chips"])
            sample = chips_last.get(idx, {})
            chip_rows.append({
                "chip": idx,
                "healthy": idx in healthy and idx not in flagged,
                "health_reason": reason,
                "duty_cycle_percent": sample.get("duty_cycle_percent"),
                "hbm_used_bytes": sample.get("hbm_used_bytes"),
                "hbm_total_bytes": chip.hbm_bytes,
                "granted_core_percent": round(sum(
                    p["chips"][idx] for p in pods.values()
                    if idx in p["chips"]
                ), 3),
                "pods": bound,
            })
        pod_rows: List[dict] = []
        for key in sorted(pods):
            pod = pods[key]
            pod_rows.append({
                "pod": key,
                "containers": pod["containers"],
                "chips": sorted(pod["chips"]),
                "resources": sorted(pod["resources"]),
                "granted_core_percent": pod["granted_percent"],
                "used_core_percent": pod.get("used_percent"),
                "tokens_per_s": pod.get("tokens_per_s"),
                "ttft_p50_s": pod.get("ttft_p50_s"),
                "hbm_granted_bytes": pod["hbm_granted_bytes"],
                "overcommit": pod.get("overcommit", False),
                "last_trace_id": pod.get("last_trace_id", ""),
                "windows": pod_windows.get(key, {}),
            })
        out = {
            "chips": chip_rows,
            "pods": pod_rows,
            "sampler": {
                "period_s": self.period_s,
                "samples_total": samples_total,
                "last_sample_ts": last_ts,
                "overcommit_episodes": self.overcommit_episodes,
                "overcommit_margin_percent": self.overcommit_margin,
                "flagged_chips": sorted(flagged),
            },
        }
        for block, attr in _STATUS_BLOCKS:
            fn = getattr(self, attr)
            if fn is not None:
                try:
                    out[block] = fn()
                except Exception:  # noqa: BLE001 - introspection only
                    pass
        return out


# -- node-doctor diagnostics bundle -------------------------------------------

BUNDLE_KIND = "elastic-tpu-node-doctor"
BUNDLE_VERSION = 1


def _fetch_json(url: str, timeout_s: float) -> dict:
    """GET ``url`` as JSON. The agent's endpoint answers JSON on every
    status, so an HTTP error's body is returned too: a 503 /healthz is
    the bundle an escalation needs, not a failed fetch."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def build_diagnostics_bundle(
    operator,
    sampler: Optional[UtilizationSampler] = None,
    tracer=None,
    node_name: str = "",
    agent_url: str = "",
    trace_limit: int = 50,
    http_timeout_s: float = 3.0,
    storage=None,
    timeline_limit: int = 200,
) -> dict:
    """One JSON document with what an escalation needs: devices, health
    and reasons, raw error counters, the allocation table with per-pod
    usage, the sampler's windows, the timeline, the reconciler's state
    and recent traces (from the running agent when ``agent_url`` is
    given, else from ``tracer``)."""
    try:
        devices = [
            {
                "uuid": c.uuid, "index": c.index,
                "device_path": c.device_path, "hbm_bytes": c.hbm_bytes,
                "cores": c.cores, "extra_paths": list(c.extra_paths),
            }
            for c in operator.devices()
        ]
    except Exception as e:  # noqa: BLE001 - partial bundles beat no bundle
        devices = []
        logger.warning("doctor: device enumeration failed: %s", e)
    try:
        healthy = sorted(operator.healthy_indexes())
    except Exception:  # noqa: BLE001
        healthy = []
    try:
        reasons = {
            str(i): r for i, r in operator.health_reasons().items()
        }
    except Exception:  # noqa: BLE001
        reasons = {}
    try:
        counters = {
            str(i): dict(v) for i, v in operator.error_counters().items()
        }
    except Exception:  # noqa: BLE001
        counters = {}
    if sampler is not None:
        for i, r in sampler.health_reasons().items():
            reasons.setdefault(str(i), r)
    bundle = {
        "kind": BUNDLE_KIND,
        "version": BUNDLE_VERSION,
        "generated_ts": time.time(),
        "node": node_name,
        "devices": devices,
        "healthy_indexes": healthy,
        "health_reasons": reasons,
        "error_counters": counters,
        "allocations": (
            sampler.allocations_snapshot() if sampler is not None
            else {"chips": [], "pods": [], "sampler": {}}
        ),
        "sampler_windows": {
            "chips": {
                str(i): w for i, w in (
                    sampler.chip_windows(now=sampler.last_sample_ts)
                    if sampler is not None else {}
                ).items()
            },
            "pods": (
                sampler.pod_windows(now=sampler.last_sample_ts)
                if sampler is not None else {}
            ),
        },
        "traces": [],
        "subsystems": {},
        "reconcile": {},
        "agent": {"url": agent_url, "reachable": None},
    }
    try:
        from .common import read_rss_bytes
        from .tracing import get_tracer

        bundle["memory"] = {
            "rss_bytes": read_rss_bytes(),
            "trace_ring_bytes": get_tracer().ring_bytes(),
        }
    except Exception as e:  # noqa: BLE001 - partial bundles beat none
        logger.warning("doctor: memory accounting failed: %s", e)
        bundle["memory"] = {"rss_bytes": 0, "trace_ring_bytes": 0}
    # The timeline straight from the db (a dead agent's too); the boot
    # identity from the never-evicted meta keys, the newest
    # agent_started row as the fallback.
    if storage is not None:
        try:
            rows = storage.timeline_rows()
            boots = [e for e in rows if e["kind"] == "agent_started"]
            last_boot = boots[-1]["attrs"] if boots else {}
            bundle["timeline"] = {
                "events": rows[-timeline_limit:] if timeline_limit
                else rows,
                "total_events": storage.timeline_count(),
                "evicted_total": storage.timeline_evicted_total(),
                "agent_version": str(
                    storage.timeline_meta_value("timeline_agent_version")
                    or last_boot.get("version", "")
                ),
                "boot_id": str(
                    storage.timeline_meta_value("timeline_boot_id")
                    or last_boot.get("boot_id", "")
                ),
            }
        except Exception as e:  # noqa: BLE001 - partial bundles beat none
            logger.warning("doctor: timeline read failed: %s", e)
        # the goodput ledger replayed from the db's journal and anchors:
        # the db is its whole input, so a dead agent's reads the same
        try:
            from .goodput import build_goodput_block

            bundle["goodput"] = build_goodput_block(storage)
        except Exception as e:  # noqa: BLE001 - partial bundles beat none
            logger.warning("doctor: goodput replay failed: %s", e)
    # The reconciler's state from the live hook, else the db's open
    # intents: a crash mid-bind must be readable with the agent down.
    live_reconcile = bundle["allocations"].get("reconcile")
    if isinstance(live_reconcile, dict):
        bundle["reconcile"] = live_reconcile
    elif storage is not None:
        try:
            bundle["reconcile"] = {
                "open_intents": storage.open_intents_brief(),
            }
        except Exception as e:  # noqa: BLE001 - partial bundles beat none
            logger.warning("doctor: journal read failed: %s", e)
    if agent_url:
        base = agent_url.rstrip("/")
        try:
            payload = _fetch_json(
                f"{base}/debug/traces?limit={trace_limit}", http_timeout_s
            )
            bundle["traces"] = payload.get("traces", [])
            bundle["agent"]["reachable"] = True
            try:
                healthz = _fetch_json(f"{base}/healthz", http_timeout_s)
                bundle["agent"]["healthz"] = healthz
                bundle["subsystems"] = healthz.get("subsystems", {})
                live = _fetch_json(
                    f"{base}/debug/allocations", http_timeout_s
                )
                bundle["agent"]["allocations"] = live
                if isinstance(live.get("reconcile"), dict):
                    bundle["reconcile"] = live["reconcile"]
            except Exception:  # noqa: BLE001 - traces were the hard part
                pass
            # optional blocks: an agent without them answers 404/503
            for key, path in (
                ("latency", "/debug/latency"),
                ("profile", "/debug/profile"),
                ("requests", "/debug/requests"),
            ):
                try:
                    bundle[key] = _fetch_json(
                        f"{base}{path}", http_timeout_s
                    )
                except Exception:  # noqa: BLE001 - optional block
                    pass
        except Exception as e:  # noqa: BLE001
            bundle["agent"]["reachable"] = False
            bundle["agent"]["error"] = str(e)
    elif tracer is not None:
        bundle["traces"] = tracer.dump(limit=trace_limit)
    return bundle


def _check_block(problems: List[str], expect, block, path: str,
                 fields) -> None:
    """A dict block at ``path`` carrying ``fields``."""
    expect(isinstance(block, dict), f"{path} must be an object")
    if isinstance(block, dict):
        for field in fields:
            expect(field in block, f"{path} missing {field!r}")


def validate_bundle(bundle: dict) -> List[str]:
    """Schema check of a doctor bundle; the problems (empty = valid).
    ``node-doctor --validate`` runs it, and support tooling refuses a
    malformed attachment with it."""
    problems: List[str] = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            problems.append(msg)

    expect(isinstance(bundle, dict), "bundle is not an object")
    if not isinstance(bundle, dict):
        return problems
    expect(bundle.get("kind") == BUNDLE_KIND,
           f"kind must be {BUNDLE_KIND!r}, got {bundle.get('kind')!r}")
    expect(isinstance(bundle.get("version"), int) and bundle["version"] >= 1,
           "version must be an int >= 1")
    expect(isinstance(bundle.get("generated_ts"), (int, float)),
           "generated_ts must be a number")
    expect(isinstance(bundle.get("node"), str), "node must be a string")
    devices = bundle.get("devices")
    expect(isinstance(devices, list), "devices must be a list")
    for i, dev in enumerate(devices if isinstance(devices, list) else []):
        if not isinstance(dev, dict):
            problems.append(f"devices[{i}] must be an object")
            continue
        for field in ("index", "device_path", "hbm_bytes", "cores"):
            expect(field in dev, f"devices[{i}] missing {field!r}")
    expect(
        isinstance(bundle.get("healthy_indexes"), list)
        and all(isinstance(i, int) for i in bundle.get("healthy_indexes", [])),
        "healthy_indexes must be a list of ints",
    )
    for field in ("health_reasons", "error_counters"):
        expect(isinstance(bundle.get(field), dict),
               f"{field} must be an object")
    allocations = bundle.get("allocations")
    expect(isinstance(allocations, dict), "allocations must be an object")
    if isinstance(allocations, dict):
        expect(isinstance(allocations.get("chips"), list),
               "allocations.chips must be a list")
        expect(isinstance(allocations.get("pods"), list),
               "allocations.pods must be a list")
        for i, pod in enumerate(
            allocations.get("pods")
            if isinstance(allocations.get("pods"), list) else []
        ):
            if not isinstance(pod, dict):
                problems.append(f"allocations.pods[{i}] must be an object")
                continue
            for field in ("pod", "granted_core_percent", "overcommit"):
                expect(field in pod,
                       f"allocations.pods[{i}] missing {field!r}")
    if isinstance(allocations, dict) and "slices" in allocations:
        # absent when no slice registry is attached (standalone
        # node-doctor)
        slices = allocations["slices"]
        expect(isinstance(slices, dict),
               "allocations.slices must be an object")
        for name, sl in (slices.items() if isinstance(slices, dict)
                         else []):
            if not isinstance(sl, dict):
                problems.append(
                    f"allocations.slices[{name!r}] must be an object")
                continue
            for field in ("hosts", "world_size", "epoch", "reforms_total"):
                expect(field in sl,
                       f"allocations.slices[{name!r}] missing {field!r}")
    if isinstance(allocations, dict) and "drain" in allocations:
        # absent when no drain hook is attached (standalone node-doctor)
        drain = allocations["drain"]
        _check_block(problems, expect, drain, "allocations.drain",
                     ("state", "trigger", "drains_total"))
        if isinstance(drain, dict):
            expect(
                drain.get("state") in (
                    "active", "cordoned", "draining", "drained", "reclaimed",
                ),
                f"allocations.drain.state {drain.get('state')!r} is not a "
                "lifecycle state",
            )
            for field in ("stamped_pods", "reclaimed_pods"):
                expect(isinstance(drain.get(field, []), list),
                       f"allocations.drain.{field} must be a list")
    if isinstance(allocations, dict) and "migration" in allocations:
        # absent when no migration hook is attached
        migration = allocations["migration"]
        expect(isinstance(migration, dict),
               "allocations.migration must be an object")
        if isinstance(migration, dict):
            for field in ("early_reclaims_total",
                          "records_published_total", "completed_total"):
                expect(
                    isinstance(migration.get(field), int),
                    f"allocations.migration.{field} must be an int",
                )
            for field in ("acked_pods", "records", "inbound"):
                expect(isinstance(migration.get(field, {}), dict),
                       f"allocations.migration.{field} must be an object")
            expect(
                isinstance(migration.get("suppressed_pods", []), list),
                "allocations.migration.suppressed_pods must be a list",
            )
    if isinstance(allocations, dict) and "repartition" in allocations:
        # absent when no controller is attached (sampler off, standalone
        # node-doctor)
        rep = allocations["repartition"]
        _check_block(problems, expect, rep, "allocations.repartition",
                     ("enabled", "edges", "throttled_pods",
                      "repartitions_total"))
        if isinstance(rep, dict):
            edges = rep.get("edges", [])
            expect(isinstance(edges, list),
                   "allocations.repartition.edges must be a list")
            for i, edge in enumerate(
                edges if isinstance(edges, list) else []
            ):
                if not isinstance(edge, dict):
                    problems.append(
                        f"allocations.repartition.edges[{i}] must be an "
                        "object"
                    )
                    continue
                for field in ("donor", "borrower", "chip", "core_units"):
                    expect(field in edge,
                           f"allocations.repartition.edges[{i}] missing "
                           f"{field!r}")
            expect(isinstance(rep.get("throttled_pods", {}), dict),
                   "allocations.repartition.throttled_pods must be an "
                   "object")
    windows = bundle.get("sampler_windows")
    expect(isinstance(windows, dict), "sampler_windows must be an object")
    if isinstance(windows, dict):
        for field in ("chips", "pods"):
            expect(isinstance(windows.get(field), dict),
                   f"sampler_windows.{field} must be an object")
    expect(isinstance(bundle.get("traces"), list), "traces must be a list")
    expect(isinstance(bundle.get("agent"), dict), "agent must be an object")
    if "memory" in bundle:
        memory = bundle["memory"]
        expect(isinstance(memory, dict), "memory must be an object")
        if isinstance(memory, dict):
            for field in ("rss_bytes", "trace_ring_bytes"):
                expect(
                    isinstance(memory.get(field), (int, float)),
                    f"memory.{field} must be a number",
                )
    if "reconcile" in bundle:
        reconcile = bundle["reconcile"]
        expect(isinstance(reconcile, dict), "reconcile must be an object")
        if isinstance(reconcile, dict) and "open_intents" in reconcile:
            intents = reconcile["open_intents"]
            expect(isinstance(intents, list),
                   "reconcile.open_intents must be a list")
            for i, intent in enumerate(
                intents if isinstance(intents, list) else []
            ):
                if not isinstance(intent, dict):
                    problems.append(
                        f"reconcile.open_intents[{i}] must be an object"
                    )
                    continue
                for field in ("pod", "resource", "hash", "age_s"):
                    expect(field in intent,
                           f"reconcile.open_intents[{i}] missing {field!r}")
    if "timeline" in bundle:  # absent only without a checkpoint db
        timeline = bundle["timeline"]
        _check_block(problems, expect, timeline, "timeline",
                     ("events", "total_events", "evicted_total",
                      "agent_version", "boot_id"))
        if isinstance(timeline, dict):
            events = timeline.get("events")
            expect(isinstance(events, list), "timeline.events must be a "
                                             "list")
            prev_seq = None
            for i, event in enumerate(
                events if isinstance(events, list) else []
            ):
                if not isinstance(event, dict):
                    problems.append(f"timeline.events[{i}] must be an "
                                    "object")
                    continue
                for field in ("seq", "ts", "kind", "keys", "attrs"):
                    expect(field in event,
                           f"timeline.events[{i}] missing {field!r}")
                seq = event.get("seq")
                if isinstance(seq, int):
                    expect(
                        prev_seq is None or seq > prev_seq,
                        f"timeline.events[{i}] seq {seq} not "
                        "monotonically increasing",
                    )
                    prev_seq = seq
            for field in ("total_events", "evicted_total"):
                expect(isinstance(timeline.get(field), int),
                       f"timeline.{field} must be an int")
    if "goodput" in bundle:  # absent only without a checkpoint db
        from .goodput import validate_goodput_block

        problems.extend(validate_goodput_block(bundle["goodput"]))
    if "latency" in bundle:
        latency = bundle["latency"]
        expect(isinstance(latency, dict), "latency must be an object")
        # a just-started agent's 503 is kept as {"error": ...}: valid
        if isinstance(latency, dict) and "bind" in latency:
            bind = latency["bind"]
            _check_block(problems, expect, bind, "latency.bind",
                         ("observed_total", "phases", "slowest"))
            if isinstance(bind, dict):
                phases = bind.get("phases")
                expect(isinstance(phases, dict),
                       "latency.bind.phases must be an object")
                for pname, ph in (
                    phases.items() if isinstance(phases, dict) else []
                ):
                    _check_block(problems, expect, ph,
                                 f"latency.bind.phases[{pname!r}]",
                                 ("count", "p50_ms", "p99_ms"))
    if "requests" in bundle:
        requests = bundle["requests"]
        expect(isinstance(requests, dict), "requests must be an object")
        if isinstance(requests, dict) and "classes" in requests:
            for field in ("live", "finished", "classes", "phases",
                          "conservation", "steps"):
                expect(field in requests,
                       f"requests missing {field!r}")
            classes = requests.get("classes")
            expect(isinstance(classes, dict),
                   "requests.classes must be an object")
            for cname, cls in (
                classes.items() if isinstance(classes, dict) else []
            ):
                _check_block(problems, expect, cls,
                             f"requests.classes[{cname!r}]",
                             ("finished", "attained", "attainment"))
            _check_block(problems, expect, requests.get("conservation"),
                         "requests.conservation",
                         ("checked", "worst_residual_ms"))
    if "profile" in bundle:
        profile = bundle["profile"]
        expect(isinstance(profile, dict), "profile must be an object")
        if isinstance(profile, dict) and "top" in profile:
            for field in ("enabled", "hz", "samples_total",
                          "overhead_ratio"):
                expect(field in profile, f"profile missing {field!r}")
            expect(isinstance(profile.get("top"), list),
                   "profile.top must be a list")
    if "subsystems" in bundle:
        subsystems = bundle["subsystems"]
        expect(isinstance(subsystems, dict), "subsystems must be an object")
        for name, sub in (
            subsystems.items() if isinstance(subsystems, dict) else []
        ):
            _check_block(problems, expect, sub, f"subsystems[{name!r}]",
                         ("criticality", "state", "restarts"))
    return problems
