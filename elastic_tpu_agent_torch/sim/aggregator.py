"""FleetAggregator: the fleet-level read side of the observatory.

The port's copy of ``elastic_tpu_agent/sim/aggregator.py``. The port's
agents keep the agent's metric names, so the rollup reads them unchanged.
Scrapes every agent's /metrics endpoint (prometheus text format — the
same bytes a production Prometheus would ingest), then rolls the node
samples up into the three fleet questions:

- **fleet bind latency**: per-node elastic_tpu_prestart_seconds
  histograms merged bucket-wise, quantiles estimated the
  histogram_quantile() way (linear interpolation inside the bucket) —
  so fleet p50/p99 is computed from scraped data, not from driver-side
  stopwatches (the driver's exact percentiles ride along as a
  cross-check).
- **reconcile convergence**: per-node
  elastic_tpu_reconcile_last_converged_timestamp; convergence time
  after an event (churn end, fault clear) = first converged timestamp
  past the anchor, minus the anchor.
- **request amplification**: elastic_tpu_kubelet_list_total and
  elastic_tpu_sink_writes_total{sink=} divided by binds — how many
  kubelet Lists and apiserver sink writes the fleet pays per bind.

Trace continuity rides the same targets' /debug/traces?trace=<id>
endpoint: admission stamps the id, the binding agent adopts it, and the
aggregator follows it to the node that bound the pod.
"""

from __future__ import annotations

import json
import math
import statistics
import time
import urllib.request
from typing import Dict, List, Optional, Tuple


def _parse_le(value: str) -> float:
    return math.inf if value == "+Inf" else float(value)


def histogram_quantile(
    buckets: Dict[float, float], q: float
) -> Optional[float]:
    """Prometheus-style quantile estimate over cumulative ``le ->
    count`` buckets (merged across nodes by summing counts per bound).
    Returns seconds, or None for an empty histogram. Values past the
    largest finite bucket clamp to that bound, like histogram_quantile().
    """
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le in bounds:
        count = buckets[le]
        if count >= rank:
            if math.isinf(le):
                # +Inf bucket: report the largest finite bound
                return prev_le
            if count == prev_count:
                return le
            return prev_le + (le - prev_le) * (
                (rank - prev_count) / (count - prev_count)
            )
        prev_le, prev_count = le, count
    return bounds[-1] if not math.isinf(bounds[-1]) else prev_le


class NodeScrape:
    """One node's parsed /metrics payload: sample name -> [(labels,
    value)], plus O(1) helpers."""

    def __init__(self, samples: Dict[str, List[Tuple[dict, float]]]) -> None:
        self.samples = samples

    def value(
        self, name: str, labels: Optional[dict] = None, default: float = 0.0
    ) -> float:
        for sample_labels, value in self.samples.get(name, []):
            if labels is None or all(
                sample_labels.get(k) == v for k, v in labels.items()
            ):
                return value
        return default

    def buckets(self, histogram: str) -> Dict[float, float]:
        out: Dict[float, float] = {}
        for sample_labels, value in self.samples.get(
            f"{histogram}_bucket", []
        ):
            if "le" in sample_labels:
                out[_parse_le(sample_labels["le"])] = value
        return out


class FleetAggregator:
    def __init__(
        self, targets: Dict[str, str], timeout_s: float = 5.0
    ) -> None:
        self.targets = dict(targets)  # node name -> http://host:port
        self.timeout_s = timeout_s

    # -- scraping -------------------------------------------------------------

    def _get(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.read()

    def scrape_node(self, node: str) -> NodeScrape:
        from prometheus_client.parser import text_string_to_metric_families

        text = self._get(f"{self.targets[node]}/metrics").decode()
        samples: Dict[str, List[Tuple[dict, float]]] = {}
        for family in text_string_to_metric_families(text):
            for sample in family.samples:
                samples.setdefault(sample.name, []).append(
                    (dict(sample.labels), sample.value)
                )
        return NodeScrape(samples)

    def scrape(self) -> Dict[str, NodeScrape]:
        return {node: self.scrape_node(node) for node in self.targets}

    # -- the fleet rollup -----------------------------------------------------

    def rollup(
        self, scrapes: Optional[Dict[str, NodeScrape]] = None
    ) -> dict:
        """One fleet snapshot: per-node rows plus the fleet aggregates
        (merged-histogram bind quantiles, request-amplification ratios,
        convergence timestamps)."""
        if scrapes is None:
            scrapes = self.scrape()
        per_node: Dict[str, dict] = {}
        merged_bind: Dict[float, float] = {}
        totals = {
            "binds": 0.0, "allocates": 0.0, "kubelet_lists": 0.0,
            "sink_writes_events": 0.0, "sink_writes_crd": 0.0,
            "series_evicted": 0.0,
        }
        for node, scrape in scrapes.items():
            binds = scrape.value("elastic_tpu_prestart_seconds_count")
            row = {
                "binds": binds,
                "allocates": scrape.value(
                    "elastic_tpu_allocate_seconds_count"
                ),
                "bound_allocations": scrape.value(
                    "elastic_tpu_bound_allocations"
                ),
                "kubelet_lists": scrape.value(
                    "elastic_tpu_kubelet_list_total"
                ),
                "sink_writes": {
                    "events": scrape.value(
                        "elastic_tpu_sink_writes_total", {"sink": "events"}
                    ),
                    "crd": scrape.value(
                        "elastic_tpu_sink_writes_total", {"sink": "crd"}
                    ),
                },
                "reconcile_runs": scrape.value(
                    "elastic_tpu_reconcile_runs_total"
                ),
                "reconcile_last_converged_ts": scrape.value(
                    "elastic_tpu_reconcile_last_converged_timestamp"
                ),
                "reconcile_duration_p50_s": histogram_quantile(
                    scrape.buckets("elastic_tpu_reconcile_duration_seconds"),
                    0.5,
                ),
                "series_evicted": scrape.value(
                    "elastic_tpu_metric_series_evicted_total"
                ),
                "open_bind_intents": scrape.value(
                    "elastic_tpu_bind_intents_open"
                ),
            }
            node_buckets = scrape.buckets("elastic_tpu_prestart_seconds")
            for le, count in node_buckets.items():
                merged_bind[le] = merged_bind.get(le, 0.0) + count
            for q, key in ((0.5, "bind_p50_ms"), (0.99, "bind_p99_ms")):
                quantile = histogram_quantile(node_buckets, q)
                row[key] = (
                    None if quantile is None else round(quantile * 1000, 3)
                )
            per_node[node] = row
            totals["binds"] += binds
            totals["allocates"] += row["allocates"]
            totals["kubelet_lists"] += row["kubelet_lists"]
            totals["sink_writes_events"] += row["sink_writes"]["events"]
            totals["sink_writes_crd"] += row["sink_writes"]["crd"]
            totals["series_evicted"] += row["series_evicted"]
        binds = totals["binds"]
        p50 = histogram_quantile(merged_bind, 0.5)
        p99 = histogram_quantile(merged_bind, 0.99)
        return {
            "nodes": len(per_node),
            "per_node": per_node,
            "fleet": {
                "binds_total": binds,
                "fleet_bind_p50_ms": (
                    None if p50 is None else round(p50 * 1000, 3)
                ),
                "fleet_bind_p99_ms": (
                    None if p99 is None else round(p99 * 1000, 3)
                ),
                "request_amplification": {
                    "kubelet_lists_total": totals["kubelet_lists"],
                    "kubelet_lists_per_bind": (
                        round(totals["kubelet_lists"] / binds, 4)
                        if binds else None
                    ),
                    "sink_writes_per_bind": {
                        "events": (
                            round(totals["sink_writes_events"] / binds, 4)
                            if binds else None
                        ),
                        "crd": (
                            round(totals["sink_writes_crd"] / binds, 4)
                            if binds else None
                        ),
                    },
                },
                "series_evicted_total": totals["series_evicted"],
            },
        }

    # -- reconcile convergence ------------------------------------------------

    def wait_converged(
        self,
        after_ts: float,
        timeout_s: float = 60.0,
        poll_s: float = 0.25,
    ) -> Dict[str, Optional[float]]:
        """Per-node reconcile convergence time after the ``after_ts``
        anchor (e.g. churn end): seconds until the node's last-converged
        timestamp first advanced past the anchor; None = never converged
        inside the timeout (THE divergent node to triage)."""
        pending = set(self.targets)
        out: Dict[str, Optional[float]] = {n: None for n in self.targets}
        deadline = time.monotonic() + timeout_s
        while pending and time.monotonic() < deadline:
            for node in sorted(pending):
                try:
                    scrape = self.scrape_node(node)
                except Exception:  # noqa: BLE001 - scrape blip: retry
                    continue
                ts = scrape.value(
                    "elastic_tpu_reconcile_last_converged_timestamp"
                )
                if ts > after_ts:
                    out[node] = round(ts - after_ts, 3)
                    pending.discard(node)
            if pending:
                time.sleep(poll_s)
        return out

    @staticmethod
    def convergence_summary(
        per_node: Dict[str, Optional[float]]
    ) -> dict:
        done = [v for v in per_node.values() if v is not None]
        return {
            "per_node": per_node,
            "converged_nodes": len(done),
            "unconverged_nodes": sorted(
                n for n, v in per_node.items() if v is None
            ),
            "median_s": round(statistics.median(done), 3) if done else None,
            "max_s": round(max(done), 3) if done else None,
        }

    # -- fleet-wide lifecycle timeline ----------------------------------------

    def node_timeline(
        self, node: str, since: Optional[float] = None
    ) -> dict:
        """One node's /debug/timeline payload (its durable journal,
        seq-ordered, plus the ring counters)."""
        url = f"{self.targets[node]}/debug/timeline"
        if since is not None:
            url += f"?since={since}"
        return json.loads(self._get(url))

    def merged_timeline(
        self,
        pod: Optional[str] = None,
        slice_id: Optional[str] = None,
        chip: Optional[int] = None,
        since: Optional[float] = None,
        kinds=None,
        limit: Optional[int] = None,
    ) -> dict:
        """Interleave every node's lifecycle journal into ONE
        fleet-ordered causal view, so a slice reform reads as one story
        — maintenance notice on node A, proactive draining annotation,
        survivors restamping at epoch N+1, reclaim — instead of N
        disjoint logs.

        Ordering: within a node, seq order (the node's own causal
        order) is never violated; across nodes the merge goes by wall
        time, and adopted trace ids (the admission id every bind
        continues under) stitch the cross-node causality no clock
        could. Entity filtering + causal expansion run over the MERGED
        list with the same semantics as one node's query
        (timeline.select_events), so a pod's fleet history includes the
        reform events its slice peers journaled on other nodes."""
        from ..timeline import merge_node_events, select_events

        per_node = {}
        unreachable = []
        for node in sorted(self.targets):
            try:
                per_node[node] = self.node_timeline(
                    node, since=since
                ).get("events", [])
            except Exception:  # noqa: BLE001 - a dead node: its journal
                unreachable.append(node)  # is still on ITS db, not here
        merged = merge_node_events(per_node)
        events = select_events(
            merged, pod=pod, slice_id=slice_id, chip=chip,
            kinds=kinds, limit=limit,
        )
        return {
            "nodes": sorted(per_node),
            "unreachable": unreachable,
            "events": events,
        }

    # -- fleet goodput (goodput.py) -------------------------------------------

    def node_goodput(self, node: str) -> dict:
        """One node's /debug/goodput payload: the ledger's per-pod
        state partitions + downtime-by-cause rollup."""
        return json.loads(self._get(f"{self.targets[node]}/debug/goodput"))

    def fleet_goodput(self) -> dict:
        """Fleet goodput % and downtime-by-cause, summed over every
        node's ledger — the SLI the migrate/drain/scale bench legs
        report next to their latency numbers.

        Migration stories get one extra join the per-node ledgers
        cannot do alone: a completed migration's TRUE downtime spans
        two pods on two nodes (source checkpoint signal -> verified
        resume on the destination), so each completion is stitched to
        the source pod's terminal non-productive run on its source
        node's ledger. Falls back to the coordinator's own measured
        window (ack -> verify) when the source ledger is unreachable."""
        per_node = {}
        unreachable = []
        for node in sorted(self.targets):
            try:
                per_node[node] = self.node_goodput(node)
            except Exception:  # noqa: BLE001 - dead node: its db still
                unreachable.append(node)  # has the ledger, not this view
        lifetime = productive = 0.0
        downtime: dict = {}
        conservation: list = []
        for node, payload in per_node.items():
            for pod, entry in payload.get("pods", {}).items():
                lifetime += entry.get("lifetime_s") or 0.0
                productive += (entry.get("states") or {}).get(
                    "productive", 0.0
                )
            for cause, seconds in payload.get(
                "downtime_by_cause", {}
            ).items():
                downtime[cause] = downtime.get(cause, 0.0) + seconds
            for problem in payload.get("conservation_problems", []):
                conservation.append(f"{node}: {problem}")
        stories = []
        for node, payload in per_node.items():
            for story in payload.get("migrations", []):
                downtime_s = story.get("coordinator_downtime_s")
                source = story.get("source_node")
                src_entry = (
                    per_node.get(source, {}).get("pods", {})
                    .get(story.get("pod"))
                    if source else None
                )
                if src_entry:
                    # the source pod's terminal non-productive run:
                    # walk back from its last interval while the state
                    # stays non-productive — its start is the signal
                    run_start = None
                    for itv in reversed(src_entry.get("intervals", [])):
                        if itv["state"] == "productive":
                            break
                        run_start = itv["start"]
                    if run_start is not None and story.get(
                        "completed_ts"
                    ) is not None:
                        downtime_s = round(
                            story["completed_ts"] - run_start, 6
                        )
                stories.append({**story, "downtime_s": downtime_s})
        return {
            "nodes": sorted(per_node),
            "unreachable": unreachable,
            "fleet": {
                "lifetime_s": round(lifetime, 6),
                "productive_s": round(productive, 6),
                "goodput_percent": (
                    round(100.0 * productive / lifetime, 3)
                    if lifetime > 0 else None
                ),
                "downtime_by_cause": {
                    k: round(v, 6) for k, v in sorted(downtime.items())
                },
            },
            "migrations": stories,
            "conservation_problems": conservation,
            "per_node": {
                node: {
                    "pods": len(payload.get("pods", {})),
                    "downtime_by_cause": payload.get(
                        "downtime_by_cause", {}
                    ),
                }
                for node, payload in per_node.items()
            },
        }

    # -- critical-path latency (latency.py) -----------------------------------

    def node_latency(self, node: str) -> dict:
        """One node's /debug/latency payload: phase-attributed bind
        breakdown + per-loop detection-lag classes."""
        return json.loads(self._get(f"{self.targets[node]}/debug/latency"))

    def fleet_detection_lag(self) -> dict:
        """Fleet origin->repair lag per divergence class: every node's
        recent detection-lag observations merged, with p50/p99 computed
        over the merged sample — the poll-bound divergence-repair lag,
        measured end to end
        from injected origin timestamps rather than driver stopwatches.

        Each node's /debug/latency keeps a bounded per-class window of
        recent observations (not the full history), so this is a rollup
        of the recent fleet, same as the per-node blocks it merges."""
        per_node = {}
        unreachable = []
        for node in sorted(self.targets):
            try:
                per_node[node] = self.node_latency(node)
            except Exception:  # noqa: BLE001 - dead node: no lag block
                unreachable.append(node)
        merged: Dict[str, List[dict]] = {}
        clamped_total = 0
        open_marks = 0
        for node, payload in per_node.items():
            lag = payload.get("detection_lag") or {}
            clamped_total += int(lag.get("clamped_total") or 0)
            open_marks += int(lag.get("open_marks") or 0)
            for cls, block in (lag.get("classes") or {}).items():
                for entry in block.get("recent", []):
                    merged.setdefault(cls, []).append(
                        {**entry, "node": node}
                    )
        classes = {}
        for cls, entries in sorted(merged.items()):
            lags = sorted(e["lag_s"] for e in entries)

            def q(p: float) -> Optional[float]:
                if not lags:
                    return None
                idx = min(len(lags) - 1, int(round(p * (len(lags) - 1))))
                return round(lags[idx], 6)

            classes[cls] = {
                "count": len(lags),
                "p50_s": q(0.5),
                "p99_s": q(0.99),
                "max_s": round(lags[-1], 6) if lags else None,
                "loops": sorted({e["loop"] for e in entries}),
                "nodes": sorted({e["node"] for e in entries}),
            }
        return {
            "nodes": sorted(per_node),
            "unreachable": unreachable,
            "classes": classes,
            "clamped_total": clamped_total,
            "open_marks": open_marks,
        }

    # -- request-level SLO (workloads/request_obs.py) -------------------------

    def node_requests(self, node: str) -> dict:
        """One node's /debug/requests payload: the request observatory's
        per-class ledgers, phase breakdown, and conservation check."""
        return json.loads(
            self._get(f"{self.targets[node]}/debug/requests")
        )

    def fleet_slo(
        self, targets: Optional[Dict[str, Dict[str, float]]] = None
    ) -> dict:
        """Fleet TTFT/TPOT percentiles and SLO attainment per class,
        merged from every node's bounded request histograms — the SLI
        the gateway PR routes against, living beside fleet_goodput.

        Node histograms merge exactly (cumulative le -> count buckets
        sum across nodes), so with one node the fleet numbers EQUAL the
        node's own exposition — the equality the request-obs smoke
        pins. Attainment per class is the cumulative bucket count at
        the class target divided by total observations; targets default
        to the observatory's (deliberately placed on bucket bounds so
        this division is exact, not interpolated). ``batch`` has no
        latency target — it attains by finishing. The observatory's
        module is imported here, not at the top: the workload package
        imports torch, which the rest of the sim never needs."""
        from ..workloads.request_obs import (
            DEFAULT_SLO_TARGETS, SLO_CLASSES,
        )

        targets = targets or DEFAULT_SLO_TARGETS
        scrapes: Dict[str, NodeScrape] = {}
        unreachable = []
        for node in sorted(self.targets):
            try:
                scrapes[node] = self.scrape_node(node)
            except Exception:  # noqa: BLE001 - dead node: skip
                unreachable.append(node)

        def slo_buckets(
            scrape: NodeScrape, name: str, slo: str
        ) -> Dict[float, float]:
            # NodeScrape.buckets() ignores non-le labels, which would
            # sum the SLO classes together — filter by hand instead
            out: Dict[float, float] = {}
            for labels, value in scrape.samples.get(
                f"{name}_bucket", []
            ):
                if labels.get("slo") == slo and "le" in labels:
                    le = _parse_le(labels["le"])
                    out[le] = out.get(le, 0.0) + value
            return out

        def merge(name: str, slo: str) -> Dict[float, float]:
            merged: Dict[float, float] = {}
            for scrape in scrapes.values():
                for le, count in slo_buckets(scrape, name, slo).items():
                    merged[le] = merged.get(le, 0.0) + count
            return merged

        def total(buckets: Dict[float, float]) -> float:
            return max(buckets.values()) if buckets else 0.0

        def attained_ratio(
            buckets: Dict[float, float], target: float
        ) -> Optional[float]:
            n = total(buckets)
            if n <= 0:
                return None
            # cumulative count at the largest bound <= target: exact
            # when the target sits on a bound (the default targets do)
            eligible = [le for le in buckets if le <= target]
            if not eligible:
                return 0.0
            return round(buckets[max(eligible)] / n, 4)

        classes = {}
        for slo in SLO_CLASSES:
            ttft = merge("elastic_tpu_request_ttft_seconds", slo)
            tpot = merge("elastic_tpu_request_tpot_seconds", slo)
            if not ttft and not tpot:
                continue
            tgt = targets.get(slo, {})
            if "ttft_s" in tgt:
                attainment = attained_ratio(ttft, tgt["ttft_s"])
            elif "tpot_s" in tgt:
                attainment = attained_ratio(tpot, tgt["tpot_s"])
            else:
                attainment = 1.0 if total(ttft) > 0 else None
            classes[slo] = {
                "ttft_observed": int(total(ttft)),
                "tpot_observed": int(total(tpot)),
                "ttft_p50_s": histogram_quantile(ttft, 0.5),
                "ttft_p99_s": histogram_quantile(ttft, 0.99),
                "tpot_p50_s": histogram_quantile(tpot, 0.5),
                "tpot_p99_s": histogram_quantile(tpot, 0.99),
                "attainment": attainment,
                "target": dict(tgt),
            }
        per_node = {}
        for node, scrape in scrapes.items():
            node_classes = {}
            for slo in SLO_CLASSES:
                att = scrape.value(
                    "elastic_tpu_request_slo_attainment_ratio",
                    {"slo": slo}, default=-1.0,
                )
                count = scrape.value(
                    "elastic_tpu_request_ttft_seconds_count",
                    {"slo": slo}, default=0.0,
                )
                if att < 0 and count <= 0:
                    continue
                node_classes[slo] = {
                    "attainment": att if att >= 0 else None,
                    "ttft_observed": int(count),
                }
            per_node[node] = {
                "live": scrape.value("elastic_tpu_requests_live"),
                "pending_handoff": scrape.value(
                    "elastic_tpu_requests_pending_handoff"
                ),
                "classes": node_classes,
            }
        return {
            "nodes": sorted(scrapes),
            "unreachable": unreachable,
            "fleet": {"classes": classes},
            "per_node": per_node,
        }

    # -- trace continuity -----------------------------------------------------

    def trace_lookup(self, trace_id: str) -> List[dict]:
        """Every completed trace carrying ``trace_id``, across all
        targets, deduplicated (in-process sims share one ring, so every
        node answers with the same traces; a real fleet has per-node
        rings and only the binding node answers)."""
        found: List[dict] = []
        seen = set()
        for node in sorted(self.targets):
            try:
                payload = json.loads(self._get(
                    f"{self.targets[node]}/debug/traces?trace={trace_id}"
                ))
            except Exception:  # noqa: BLE001 - an unreachable node: skip
                continue
            for trace in payload.get("traces", []):
                key = (
                    trace.get("trace_id"), trace.get("name"),
                    trace.get("start_ts"),
                )
                if key in seen:
                    continue
                seen.add(key)
                found.append(trace)
        return found

    def check_continuity(
        self, samples: List[Tuple[str, str, str]]
    ) -> dict:
        """``samples`` = (expected_node, admission_trace_id, pod_key)
        triples; a sample is continuous when a completed bind
        (PreStartContainer) trace under the admission id exists AND its
        ``node`` attribute names the node kubelet actually bound the pod
        on. Returns the continuity fraction + the broken samples."""
        broken: List[dict] = []
        for expected_node, trace_id, pod_key in samples:
            traces = self.trace_lookup(trace_id)
            binds = [
                t for t in traces
                if t.get("name") == "PreStartContainer"
                and t.get("attrs", {}).get("node") == expected_node
            ]
            if not binds:
                broken.append({
                    "pod": pod_key,
                    "trace_id": trace_id,
                    "expected_node": expected_node,
                    "found_traces": len(traces),
                })
        n = len(samples)
        return {
            "sampled": n,
            "continuous": n - len(broken),
            "fraction": round((n - len(broken)) / n, 4) if n else None,
            "broken": broken[:5],
        }
