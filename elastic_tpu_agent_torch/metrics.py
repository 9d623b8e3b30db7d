"""Prometheus metrics and the agent's observability endpoint.

The port's copy of ``elastic_tpu_agent/metrics.py``. ``AgentMetrics``
declares every family of the agent's, with its name, type and label set:
they are a contract that dashboards and fleet aggregation read, and
``tests/test_torch_metrics.py`` holds the two declarations equal. The
repartition controller (repartition.py) feeds the repartition, throttle
and QoS-eviction counters, the goodput ledger (goodput.py) the
goodput-ratio and downtime families, the slice registry (slices/) the
slice-member and reform families and the plugins the packing histogram.
``attach_sampler`` points ``/debug/allocations`` at
the utilization sampler and ``attach_goodput`` ``/debug/goodput`` at the
ledger (each 503 until then).

One HTTP server serves:

- ``/metrics``: the Prometheus scrape (``prometheus_client``, imported
  here only, so that an agent without ``--metrics-port`` never needs it);
- ``/debug``: the index of the debug routes (:data:`DEBUG_ROUTES`);
- ``/debug/traces``: the allocation-trace ring (tracing.py), newest
  first, ``?pod=&trace=&limit=``;
- ``/debug/timeline``: the durable lifecycle journal (timeline.py),
  ``?pod=&slice=&chip=&node=&since=&kind=&limit=``;
- ``/debug/latency``, ``/debug/profile``, ``/debug/requests``: the bind
  phase observatory and detection lag (latency.py), the sampling
  profiler (profiler.py), the request observatory of a serving tenant
  (workloads/request_obs.py);
- ``/healthz``: liveness, 200 and a small JSON status (503 once a
  critical subsystem is circuit-broken).

``/debug/*`` answers loopback clients only. Per-pod labeled gauges go
through a cardinality guard (BoundedLabeledGauge). A port conflict
raises MetricsServerError with an actionable message; ``serve_with_retry``
keeps retrying the bind in the background.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from prometheus_client import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)
from prometheus_client.exposition import CONTENT_TYPE_LATEST

logger = logging.getLogger(__name__)

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Reconcile passes span ms (quiet tick) to seconds (a full node repair
# diffing four sources of truth), so they get their own wider buckets.
_RECONCILE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)

# Detection lag spans poll periods: sub-poll (origin landed mid-pass) to
# minutes (a wedged loop limping on supervisor restarts). The low end
# must resolve a <50ms event-to-repair target, the
# high end the ~0.7s..multi-period reality being replaced.
_DETECTION_LAG_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0,
)

# Prometheus label values for the async observability sinks: the fleet
# aggregator sums per-sink apiserver traffic, and "events"/"crd" read
# better on a dashboard than the internal worker-thread names.
SINK_LABELS = {"event-recorder": "events", "crd-recorder": "crd"}

DEFAULT_BIND_ADDR = "127.0.0.1"

# Registered debug routes, served as the /debug index so an operator on
# a node shell can discover the surfaces without reading source; the
# 404 body for unknown /debug/* paths carries the same list. One dict —
# a new endpoint added to the handler but not here fails the pinned
# index test, not an operator on a node shell.
DEBUG_ROUTES = {
    "/debug/traces": "allocation-trace ring (?pod=&trace=&limit=)",
    "/debug/allocations": "live chip->pod table + subsystem blocks",
    "/debug/timeline": "durable lifecycle journal "
                       "(?pod=&slice=&chip=&node=&since=&kind=&limit=)",
    "/debug/goodput": "goodput ledger: per-pod state partition + "
                      "downtime by cause (?pod=&since=)",
    "/debug/latency": "critical-path observatory: bind phase breakdown "
                      "+ per-loop detection lag (?top=)",
    "/debug/profile": "continuous sampling profiler: hottest stacks + "
                      "measured overhead (?top=)",
    "/debug/requests": "request-level serving observatory: per-request "
                       "partitions, SLO classes, step breakdown "
                       "(?id=&slo=&limit=)",
}


class MetricsServerError(RuntimeError):
    """The observability HTTP endpoint could not start (e.g. the port is
    already bound). Deliberately NOT an OSError: callers must be able to
    catch exactly this and keep the agent running without the endpoint."""


# Distinct pod label sets kept per pod-labeled gauge. Sized for a busy
# node (kubelet caps ~a few hundred pods); beyond it the OLDEST-touched
# series is evicted, so live pods always win over churned ones.
DEFAULT_MAX_POD_SERIES = 512


class BoundedLabeledGauge:
    """Cardinality guard around a labeled Gauge: at most ``max_series``
    distinct label sets, evicting the least-recently-set. Each set()
    refreshes its series' recency, so only series nothing updates any
    more (churned pods) age out."""

    def __init__(self, gauge, max_series: int, evicted=None) -> None:
        self._gauge = gauge
        self._max = max(1, max_series)
        self._evicted = evicted  # optional Counter
        self._lock = threading.Lock()
        self._series: "OrderedDict[tuple, None]" = OrderedDict()

    def _key(self, labels: dict) -> tuple:
        return tuple(labels[name] for name in self._gauge._labelnames)

    def set(self, value: float, **labels) -> None:
        # Tracking AND the underlying gauge mutations happen under the
        # one lock: with them split (the original shape), a concurrent
        # writer could re-set a key between this thread's eviction pop
        # and its child remove(), silently deleting a series the tracker
        # still counted — the 10k-series fleet-churn test catches exactly
        # that. The prometheus-client child ops take their own internal
        # lock and never call back into ours, so nesting is safe.
        key = self._key(labels)
        with self._lock:
            self._series[key] = None
            self._series.move_to_end(key)
            self._gauge.labels(**labels).set(value)
            while len(self._series) > self._max:
                old, _ = self._series.popitem(last=False)
                try:
                    self._gauge.remove(*old)
                except KeyError:
                    pass
                if self._evicted is not None:
                    self._evicted.inc()

    def remove(self, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series.pop(key, None)
            try:
                self._gauge.remove(*key)
            except KeyError:
                pass

    @property
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)


class AgentMetrics:
    def __init__(
        self, registry=None, max_pod_series: int = DEFAULT_MAX_POD_SERIES
    ) -> None:
        self._registry = registry if registry is not None else REGISTRY
        kw = {"registry": registry} if registry is not None else {}
        self.allocate_latency = Histogram(
            "elastic_tpu_allocate_seconds",
            "Device-plugin Allocate() handler latency",
            buckets=_BUCKETS,
            **kw,
        )
        self.prestart_latency = Histogram(
            "elastic_tpu_prestart_seconds",
            "Device-plugin PreStartContainer() handler latency "
            "(includes pod-resources Locate)",
            buckets=_BUCKETS,
            **kw,
        )
        self.chips = Gauge(
            "elastic_tpu_chips", "Physical cards (chips) discovered", **kw
        )
        self.healthy_chips = Gauge(
            "elastic_tpu_chips_healthy",
            "Chips currently advertised Healthy to kubelet",
            **kw,
        )
        self.bound_allocations = Gauge(
            "elastic_tpu_bound_allocations",
            "Live pod->chip bindings recorded in storage",
            **kw,
        )
        self.bind_inflight = Gauge(
            "elastic_tpu_bind_inflight",
            "PreStartContainer binds currently in flight across both "
            "resource servers",
            **kw,
        )
        self.bind_lock_wait = Histogram(
            "elastic_tpu_bind_lock_wait_seconds",
            "Time a bind spent waiting for its per-owner bind-lock stripe "
            "(contention = sibling core/memory pair, or stripe collision)",
            buckets=_BUCKETS,
            **kw,
        )
        self.gc_reclaimed = Counter(
            "elastic_tpu_gc_reclaimed_total",
            "Allocations reclaimed by GC",
            **kw,
        )
        self.restored_links = Counter(
            "elastic_tpu_restored_links_total",
            "Virtual device nodes re-created by restore()",
            **kw,
        )
        # -- build identity & lifecycle timeline (timeline.py) -------------
        self.build_info = Gauge(
            "elastic_tpu_build_info",
            "Always 1; the labels carry the agent build identity "
            "(prometheus build-info convention) — join with "
            "elastic_tpu_agent_start_time_seconds to see which version "
            "restarted when",
            ["version"],
            **kw,
        )
        self.agent_start_time = Gauge(
            "elastic_tpu_agent_start_time_seconds",
            "Unix time this agent process started serving; a reset "
            "marks a restart even when counters alone are ambiguous",
            **kw,
        )
        self.timeline_events = Counter(
            "elastic_tpu_timeline_events_total",
            "Lifecycle events journaled into the durable timeline this "
            "boot (the journal itself persists across restarts)",
            **kw,
        )
        self.timeline_evicted = Gauge(
            "elastic_tpu_timeline_evicted_rows",
            "Durable count of timeline events the ring cap has dropped "
            "(reads the journal's own eviction counter)",
            **kw,
        )
        # -- continuous reconciler (reconciler.py) -------------------------
        self.reconcile_repairs = Counter(
            "elastic_tpu_reconcile_repairs_total",
            "Divergences repaired by the reconciler, per divergence class",
            ["kind"],
            **kw,
        )
        self.reconcile_runs = Counter(
            "elastic_tpu_reconcile_runs_total",
            "Reconciler passes completed (boot restore included)",
            **kw,
        )
        self.reconcile_duration = Histogram(
            "elastic_tpu_reconcile_duration_seconds",
            "Wall time of one full reconcile pass (store <-> kubelet <-> "
            "disk <-> live-pod diff plus repairs)",
            buckets=_RECONCILE_BUCKETS,
            **kw,
        )
        self.reconcile_last_converged = Gauge(
            "elastic_tpu_reconcile_last_converged_timestamp",
            "Unix time of the last reconcile pass that ended with the "
            "node fully converged: no failed sweeps/replays, no snapshot "
            "error, no corrupt records, nothing observed diverged or "
            "pending confirmation. A node whose value stops advancing "
            "while the fleet's does is the one to triage.",
            **kw,
        )
        self.orphan_sweep_failures = Counter(
            "elastic_tpu_orphan_sweep_failures_total",
            "Orphan link/spec deletions that failed; each is retried on "
            "the next reconcile pass instead of being dropped",
            **kw,
        )
        self.open_bind_intents = Gauge(
            "elastic_tpu_bind_intents_open",
            "Uncommitted bind intents in the write-ahead journal "
            "(sustained non-zero = a bind crashed and was not yet "
            "recovered, or a bind is wedged mid-flight)",
            **kw,
        )
        self.series_evicted = Counter(
            "elastic_tpu_metric_series_evicted_total",
            "Labeled metric series evicted by the cardinality guard",
            **kw,
        )
        # -- slice orchestration (slices/) ---------------------------------
        self.packing_span = Histogram(
            "elastic_tpu_packing_ici_span",
            "Total pairwise ICI hop count of a bind's chip set (the "
            "packing score: 0 = single chip, 1 = one adjacent pair; a "
            "rising distribution means grants are landing scattered "
            "across the mesh instead of on adjacent sub-grids)",
            buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16),
            **kw,
        )
        # Bounded like every per-pod series: slice ids are job-unique,
        # and under --reconcile-dry-run nothing prunes them, so a plain
        # labeled gauge would grow the scrape without bound under churn.
        # (slice_reforms stays a plain Counter: its series only appear
        # when a reform EXECUTES, which dry-run never does, and prune
        # removes them with the slice.)
        self.slice_members = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_slice_members",
                "Current world size (member hosts) of a multi-host "
                "slice this node hosts a member of",
                ["slice"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.slice_reforms = Counter(
            "elastic_tpu_slice_reforms_total",
            "Elastic slice reforms executed on this node (member loss "
            "or rejoin -> topology env re-emitted at the new world "
            "size, epoch bumped)",
            ["slice"],
            **kw,
        )
        # -- graceful drain lifecycle (drain.py) ---------------------------
        self.maintenance_imminent = Gauge(
            "elastic_tpu_maintenance_imminent",
            "1 while GCE announces an upcoming host maintenance event "
            "for this node (MIGRATE/TERMINATE_ON_HOST_MAINTENANCE), "
            "else 0 — set the moment detection first trips, before any "
            "drain work starts",
            **kw,
        )
        self.drain_state = Gauge(
            "elastic_tpu_drain_state",
            "Drain lifecycle state of this node: 0=active 1=cordoned "
            "2=draining 3=drained 4=reclaimed",
            **kw,
        )
        self.drains_total = Counter(
            "elastic_tpu_drains_total",
            "Drain lifecycles COMPLETED on this node, by trigger source "
            "and outcome: drained_acked = every resident acknowledged a "
            "durable checkpoint before its bindings went (the drain "
            "saved the work), drained_exited = residents merely exited "
            "(a pre-checkpoint crash looks identical from outside — "
            "nothing proves work was saved), reclaimed = the deadline "
            "fired, cancelled = the trigger cleared mid-drain",
            ["trigger", "outcome"],
            **kw,
        )
        self.drain_reclaimed_pods = Counter(
            "elastic_tpu_drain_reclaimed_pods_total",
            "Resident pods whose bindings were reclaimed because the "
            "drain deadline expired before they exited",
            **kw,
        )
        self.drain_phase_seconds = Histogram(
            "elastic_tpu_drain_phase_seconds",
            "Wall time of one drain-lifecycle phase: "
            "cordon_to_signaled (cordon until every resident carried "
            "the checkpoint signal), signaled_to_drained (residents "
            "all exited gracefully), signaled_to_reclaimed (the "
            "deadline fired instead) — a fleet whose mass sits in "
            "reclaimed instead of drained has a checkpoint problem, "
            "not a drain problem",
            ["phase"],
            buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0,
                     300.0, 600.0, 1800.0),
            **kw,
        )
        # -- migration handshake (migration.py) ----------------------------
        self.workload_checkpoint_age = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_workload_checkpoint_age_seconds",
                "Seconds since each resident pod last acknowledged a "
                "durable checkpoint (ack/<hash>.json on the alloc "
                "surface) — 'are we actually checkpointing?' from one "
                "scrape. Series exist only for pods that have EVER "
                "acked; a bound pod with no series has never "
                "checkpointed under the handshake",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        # -- goodput ledger (goodput.py) -----------------------------------
        # Ratio per pod is bounded like every per-pod series; downtime by
        # cause is a small closed vocabulary (goodput.CAUSES), exported
        # as a gauge over the ledger's replayed totals — the journal is
        # the durable source of truth, the scrape only mirrors it.
        self.goodput_ratio = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_goodput_ratio",
                "Fraction of a live pod's known lifetime the goodput "
                "ledger attributes to productive time (1.0 = nothing "
                "the agent did got in the way; see /debug/goodput for "
                "the per-interval attribution)",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.downtime_seconds = Gauge(
            "elastic_tpu_downtime_seconds_total",
            "Non-productive pod-seconds attributed to each cause by the "
            "goodput ledger's journal replay (maintenance_drain, "
            "preemption, operator_drain, qos_throttle, qos_evict, "
            "migration, migration_precopy, migration_cutover, "
            "slice_reform, agent_restart, bind_queue, unattributed) — "
            "the fleet aggregator sums this per cause",
            ["cause"],
            **kw,
        )
        self.workload_tokens_per_s = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_workload_tokens_per_second",
                "Latest tokens/s a pod's flight recorder published to "
                "its alloc-surface sidecar (flight/<hash>.json) — what "
                "the workload ACHIEVED on its grant, next to the "
                "granted/used percents. Series exist only for pods "
                "that publish, and go away with the pod's bindings.",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.workload_ttft = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_workload_ttft_seconds",
                "Median time-to-first-token a pod's flight recorder "
                "published to its alloc-surface sidecar — the serving "
                "latency the pod ACHIEVED, next to its tokens/s. Same "
                "freshness rule as tokens/s: stale summaries drop the "
                "series rather than freeze it.",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.drain_early_reclaims = Counter(
            "elastic_tpu_drain_early_reclaims_total",
            "Draining residents reclaimed BEFORE the deadline because "
            "their checkpoint ack was durable — the chips the "
            "handshake freed early",
            **kw,
        )
        self.migration_records = Counter(
            "elastic_tpu_migration_records_total",
            "MigrationRecords published (and confirmed) at the "
            "apiserver for residents whose checkpoints were verified "
            "durable before reclaim",
            **kw,
        )
        self.migrations_completed = Counter(
            "elastic_tpu_migrations_completed_total",
            "Inbound migrations VERIFIED on this node: the replacement "
            "pod restored and acked a resume at step >= the record's "
            "acked step and the current slice world size",
            **kw,
        )
        # -- dynamic re-partitioning & QoS enforcement (repartition.py) ----
        self.repartitions = Counter(
            "elastic_tpu_repartitions_total",
            "Live quota moves executed by the repartition controller: "
            "grow = a busy pod absorbed a co-located idle pod's slack, "
            "shrink = slack returned to a donor under pressure (or a "
            "peer leaving unwound the donation)",
            ["direction"],
            **kw,
        )
        self.throttles = Counter(
            "elastic_tpu_throttles_total",
            "Sustained-overcommit escalations from alarm to throttle: "
            "the pod's quota was clamped back to its base grant and the "
            "evict deadline armed",
            **kw,
        )
        self.qos_evictions = Counter(
            "elastic_tpu_qos_evictions_total",
            "Throttled pods still overcommitting at the evict deadline "
            "whose bindings were reclaimed through the reconciler's "
            "reclaimed_pod repair class",
            **kw,
        )
        # -- serving data plane (workloads/serving.py) ---------------------
        # All read through attach_serving's set_function hooks: the
        # engine's hot path never touches prometheus, and the values
        # are the engine's own monotone counters (gauges rather than
        # Counters because the source of truth lives in the engine).
        self.serving_pool_blocks = Gauge(
            "elastic_tpu_serving_pool_blocks",
            "Total KV block-pool capacity of the attached serving "
            "engine (junk block included)",
            **kw,
        )
        self.serving_pool_used = Gauge(
            "elastic_tpu_serving_pool_used_blocks",
            "KV pool blocks currently held (live request tables + "
            "registered prefixes + prefix-cache holdings)",
            **kw,
        )
        self.serving_prefix_cache_hits = Gauge(
            "elastic_tpu_serving_prefix_cache_hits",
            "Admissions that reused at least one cached prefix block "
            "(engine-lifetime count)",
            **kw,
        )
        self.serving_prefix_cache_misses = Gauge(
            "elastic_tpu_serving_prefix_cache_misses",
            "Admissions that reused nothing from the prefix cache "
            "(engine-lifetime count)",
            **kw,
        )
        self.serving_prefix_cache_evictions = Gauge(
            "elastic_tpu_serving_prefix_cache_evictions",
            "Cached blocks dropped under pool pressure or the cache "
            "cap (engine-lifetime count)",
            **kw,
        )
        self.serving_prefix_cache_hit_rate = Gauge(
            "elastic_tpu_serving_prefix_cache_hit_rate",
            "hits / (hits + misses) of the automatic prefix cache; "
            "a falling rate under steady traffic means the shared "
            "prefixes stopped fitting the pool",
            **kw,
        )
        self.serving_prefilled_tokens = Gauge(
            "elastic_tpu_serving_prefilled_tokens",
            "Prompt tokens actually run through a prefill forward "
            "(engine-lifetime; compare with "
            "elastic_tpu_serving_admitted_tokens for the cache's "
            "savings)",
            **kw,
        )
        self.serving_admitted_tokens = Gauge(
            "elastic_tpu_serving_admitted_tokens",
            "Prompt tokens admitted including cache-reused ones "
            "(engine-lifetime)",
            **kw,
        )
        # Disaggregated prefill/decode serving (SharedKVPool roles):
        # per-role backlog plus the cross-role block-adoption counter —
        # the phase-imbalance signal the repartition controller exploits.
        self.serving_role_queue_depth = Gauge(
            "elastic_tpu_serving_role_queue_depth",
            "Backlog of a serving role sharing the paged KV pool: "
            "pending chunked prefills for the prefill role, live decode "
            "requests (plus pending tails) for the decode role",
            ["role"],
            **kw,
        )
        self.serving_pool_adoptions = Gauge(
            "elastic_tpu_serving_pool_adoptions",
            "Admissions that adopted shared-pool KV blocks another role "
            "prefilled (refcounted via the prefix cache; "
            "engine-lifetime count)",
            **kw,
        )
        self.serving_pool_adopted_tokens = Gauge(
            "elastic_tpu_serving_pool_adopted_tokens",
            "Prompt tokens adopted from shared-pool blocks another role "
            "prefilled (engine-lifetime count)",
            **kw,
        )
        # Speculative decoding + MoE routing (workloads/speculative.py,
        # workloads/moe.py): the bench-only workloads joining the
        # observability plane. Absent blocks read as 0 — a plain engine
        # needs no shape change.
        self.serving_spec_drafted = Gauge(
            "elastic_tpu_serving_spec_drafted_tokens",
            "Draft-model tokens proposed by the speculative decode "
            "loop (engine-lifetime count; 0 when speculation is off)",
            **kw,
        )
        self.serving_spec_accepted = Gauge(
            "elastic_tpu_serving_spec_accepted_tokens",
            "Drafted tokens that survived target-model verification "
            "(engine-lifetime count)",
            **kw,
        )
        self.serving_spec_acceptance_rate = Gauge(
            "elastic_tpu_serving_spec_acceptance_rate",
            "accepted/drafted for the speculative decode loop — a "
            "falling rate means the draft model stopped predicting the "
            "target and the speedup is gone",
            **kw,
        )
        self.serving_moe_imbalance = Gauge(
            "elastic_tpu_serving_moe_expert_imbalance",
            "max/mean expert load of the attached MoE router's observed "
            "routing (1.0 = perfectly balanced; capacity overflow drops "
            "rise with it)",
            **kw,
        )
        self.serving_moe_dropped = Gauge(
            "elastic_tpu_serving_moe_dropped_tokens",
            "Tokens dropped by MoE expert-capacity overflow (observed-"
            "lifetime count)",
            **kw,
        )
        # -- request-level serving observatory (workloads/request_obs.py) --
        # Gauges read at scrape via attach_requests; the TTFT/TPOT/phase
        # histograms live with the other histograms below and are
        # observed at source on request finish.
        self.requests_live = Gauge(
            "elastic_tpu_requests_live",
            "Requests currently holding a slot on an attached serving "
            "engine (open partitions, pending handoffs excluded)",
            **kw,
        )
        self.requests_pending_handoff = Gauge(
            "elastic_tpu_requests_pending_handoff",
            "Disaggregated requests published by a prefill role and not "
            "yet adopted by a decode role — a growing value means the "
            "decode side stopped draining the handoff registry",
            **kw,
        )
        self.request_slo_attainment = Gauge(
            "elastic_tpu_request_slo_attainment_ratio",
            "Fraction of finished requests in an SLO class that met "
            "their target (ttft<=target, tpot<=target, batch=finished); "
            "-1 until the class has finished requests",
            ["slo"],
            **kw,
        )
        # -- self-memory accounting (bounded memory at
        # 10k+ pod-series must be observable OUTSIDE the scale harness)
        self.agent_rss = Gauge(
            "elastic_tpu_agent_rss_bytes",
            "Resident set size of the agent process (/proc/self/statm; "
            "0 where /proc is unavailable). Divide by the live series/"
            "pod count for the per-series memory the scale leg asserts "
            "a ceiling on.",
            **kw,
        )
        self.trace_ring_bytes = Gauge(
            "elastic_tpu_trace_ring_bytes",
            "Approximate bytes held by the in-process allocation-trace "
            "ring (sampled-extrapolated estimate; tracing.py). The ring "
            "is capacity-bounded — this gauge is how that bound stays "
            "falsifiable under churn.",
            **kw,
        )
        from .common import read_rss_bytes

        self.agent_rss.set_function(read_rss_bytes)

        def _ring_bytes() -> float:
            try:
                from .tracing import get_tracer

                return float(get_tracer().ring_bytes())
            except Exception:  # noqa: BLE001 - scrape must never break
                return 0.0

        self.trace_ring_bytes.set_function(_ring_bytes)
        # -- storage write amplification (storage/batcher.py) --------------
        # Gauges over the store's own monotone counters (set_function via
        # attach_storage): commits/writes per bind is the fleet
        # aggregator's storage-amplification numerator.
        self.storage_writes = Gauge(
            "elastic_tpu_storage_writes_total",
            "Logical write transactions requested of the checkpoint "
            "store (each was one sqlite COMMIT before group-commit "
            "batching)",
            **kw,
        )
        self.storage_commits = Gauge(
            "elastic_tpu_storage_commits_total",
            "sqlite COMMITs the checkpoint store actually paid; with "
            "--storage-batch-window > 0 one commit covers many writes "
            "(compare with elastic_tpu_storage_writes_total)",
            **kw,
        )
        self.observability_dropped = Counter(
            "elastic_tpu_observability_dropped_total",
            "CRD/event writes dropped by the bounded async queue",
            **kw,
        )
        self.nri_injections = Counter(
            "elastic_tpu_nri_injections_total",
            "Containers adjusted (devices injected) via the NRI plugin",
            **kw,
        )
        # AsyncSink introspection (async_sink.py): the observability
        # paths self-disable after consecutive failures — without these
        # the self-disabling is itself invisible until someone wonders
        # where the Events went.
        self.sink_writes = Counter(
            "elastic_tpu_sink_writes_total",
            "Apiserver write ops drained by an async observability sink "
            "(request-amplification accounting: the fleet aggregator "
            "divides this by binds to get sink traffic per bind)",
            ["sink"],
            **kw,
        )
        self.kubelet_lists = Counter(
            "elastic_tpu_kubelet_list_total",
            "Full pod-resources List RPCs issued to kubelet (locator "
            "refresh/prefetch + reconciler snapshots) — the kubelet side "
            "of per-bind request amplification",
            **kw,
        )
        self.apiserver_pod_lists = Counter(
            "elastic_tpu_apiserver_pod_list_total",
            "Full-cluster pod LISTs issued to the apiserver (slice "
            "membership refresh, TTL-cached) — the apiserver side of "
            "request amplification; every list is counted at the "
            "source, never inferred",
            **kw,
        )
        self.sink_queue_depth = Gauge(
            "elastic_tpu_sink_queue_depth",
            "Ops queued in an async observability sink",
            ["sink"],
            **kw,
        )
        self.sink_merged = Gauge(
            "elastic_tpu_sink_merged_ops",
            "Queued sink ops superseded by a newer same-key write before "
            "draining — apiserver writes the coalescing window saved",
            ["sink"],
            **kw,
        )
        self.sink_consecutive_failures = Gauge(
            "elastic_tpu_sink_consecutive_failures",
            "Consecutive write failures of an async observability sink "
            "(resets to 0 on success; the sink disables at its limit)",
            ["sink"],
            **kw,
        )
        self.sink_disabled = Gauge(
            "elastic_tpu_sink_disabled",
            "1 when an async observability sink has self-disabled after "
            "repeated failures, else 0",
            ["sink"],
            **kw,
        )
        # -- utilization & health accounting (sampler.py) -----------------
        self.chip_duty_cycle = Gauge(
            "elastic_tpu_chip_duty_cycle_percent",
            "Last sampled per-chip duty cycle (0-100)",
            ["chip"],
            **kw,
        )
        self.chip_hbm_used = Gauge(
            "elastic_tpu_chip_hbm_used_bytes",
            "Last sampled per-chip HBM usage",
            ["chip"],
            **kw,
        )
        self.pod_core_granted = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_pod_core_granted_percent",
                "Fractional tpu-core percent granted to a pod",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.pod_core_used = BoundedLabeledGauge(
            Gauge(
                "elastic_tpu_pod_core_used_percent",
                "Sampler-attributed tpu-core percent a pod is using",
                ["pod"],
                **kw,
            ),
            max_series=max_pod_series,
            evicted=self.series_evicted,
        )
        self.overcommit_detected = Counter(
            "elastic_tpu_overcommit_detected_total",
            "Sustained-overcommit episodes: a pod's attributed core usage "
            "stayed above its fractional grant",
            **kw,
        )
        # -- subsystem supervision (supervisor.py) -------------------------
        self.subsystem_up = Gauge(
            "elastic_tpu_subsystem_up",
            "1 while a supervised subsystem is running, 0 when crashed, "
            "circuit-broken or stopped",
            ["subsystem"],
            **kw,
        )
        self.subsystem_restarts = Counter(
            "elastic_tpu_subsystem_restarts_total",
            "Crash-restarts performed by the supervisor, per subsystem",
            ["subsystem"],
            **kw,
        )
        self.subsystem_crash_loops = Counter(
            "elastic_tpu_subsystem_crash_loops_total",
            "Circuit-breaker openings (subsystem crashed too often inside "
            "the sliding window and was marked failed)",
            ["subsystem"],
            **kw,
        )
        self.thread_crashes = Counter(
            "elastic_tpu_thread_crashes_total",
            "Threads that died on an uncaught exception (process-wide "
            "threading.excepthook; supervised subsystems never reach it)",
            **kw,
        )
        self.sitter_sync_age = Gauge(
            "elastic_tpu_sitter_sync_age_seconds",
            "Seconds since the pod cache last synced with the apiserver "
            "(list success or watch event); -1 before the first sync",
            **kw,
        )
        # -- critical-path latency observatory (latency.py) ----------------
        self.bind_phase_seconds = Histogram(
            "elastic_tpu_bind_phase_seconds",
            "Bind critical-path time attributed per phase (lock wait, "
            "kubelet list, storage sync, spec write, sink enqueue, "
            "sidecar; 'unattributed' is the residual vs the measured "
            "total). Bucket exemplars (trace ids) are served at "
            "/debug/latency since the text exposition cannot carry them.",
            ["phase"],
            buckets=_BUCKETS,
            **kw,
        )
        self.request_ttft = Histogram(
            "elastic_tpu_request_ttft_seconds",
            "Measured time-to-first-token per finished serving request, "
            "labeled by SLO class (fixed vocabulary ttft|tpot|batch — "
            "junk annotations coerce to batch, never mint labels). For "
            "stitched disaggregated requests this spans the handoff.",
            ["slo"],
            buckets=_BUCKETS,
            **kw,
        )
        self.request_tpot = Histogram(
            "elastic_tpu_request_tpot_seconds",
            "Mean per-token decode interval per finished serving "
            "request (>=2 tokens), labeled by SLO class",
            ["slo"],
            buckets=_BUCKETS,
            **kw,
        )
        self.request_phase_seconds = Histogram(
            "elastic_tpu_request_phase_seconds",
            "Per-request time attributed per partition phase "
            "(queued|prefill|decode|stalled|handoff); the per-request "
            "conservation residual is served at /debug/requests",
            ["phase"],
            buckets=_BUCKETS,
            **kw,
        )
        self.detection_lag = Histogram(
            "elastic_tpu_detection_lag_seconds",
            "Divergence origin -> detection/repair latency per control "
            "loop (reconciler, gc, drain, sampler, repartition, "
            "migration, goodput). trigger=event|poll records what woke "
            "the observing pass (targeted event-bus pass vs the "
            "periodic safety-net sweep), so event-vs-poll lag is "
            "directly comparable per loop",
            ["loop", "stage", "trigger"],
            buckets=_DETECTION_LAG_BUCKETS,
            **kw,
        )
        self.detection_lag_clamped = Counter(
            "elastic_tpu_detection_lag_clamped_total",
            "Detection-lag observations whose origin timestamp was in "
            "the future (clock skew) and were clamped to 0 instead of "
            "exported negative",
            **kw,
        )
        # -- metrics-server self-observability -----------------------------
        self.scrape_duration = Histogram(
            "elastic_tpu_scrape_duration_seconds",
            "Wall time the observability HTTP handler spent answering a "
            "request (all paths) — the scraper's own cost, measured",
            buckets=_BUCKETS,
            **kw,
        )
        self.scrape_requests = Counter(
            "elastic_tpu_scrape_requests_total",
            "Requests answered by the observability HTTP handler; path "
            "label is the normalized route ('other' for unknown paths, "
            "so cardinality stays bounded under scanner noise)",
            ["path"],
            **kw,
        )
        # -- continuous self-profiler (profiler.py) ------------------------
        self.profiler_overhead = Gauge(
            "elastic_tpu_profiler_overhead_ratio",
            "Fraction of wall time the sampling profiler spends walking "
            "stacks (its measured self-cost; the latency smoke pins it "
            "<= 1%); 0 while disabled",
            **kw,
        )
        self.profiler_samples = Gauge(
            "elastic_tpu_profiler_samples_total",
            "Stack-walk samples taken by the continuous profiler since "
            "agent start",
            **kw,
        )
        self._sampler = None
        self._supervisor = None
        self._sitter = None
        self._timeline = None
        self._goodput = None
        self._latency = None
        self._lag = None
        self._profiler = None
        self._requests = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    def attach_sampler(self, sampler) -> None:
        """Point /debug/allocations at a live UtilizationSampler. Late on
        purpose: the endpoint starts before the manager (cli.py) and
        answers 503 until the sampler exists."""
        self._sampler = sampler

    def attach_timeline(self, timeline) -> None:
        """Point /debug/timeline at the agent's lifecycle journal
        (timeline.py); the endpoint answers 503 until attached, like
        /debug/allocations. Also exports the journal's durable eviction
        counter and stamps the boot id into /healthz."""
        self._timeline = timeline

        def _evicted() -> float:
            try:
                return float(timeline.status().get("evicted_total") or 0)
            except Exception:  # noqa: BLE001 - scrape must never break
                return 0.0

        self.timeline_evicted.set_function(_evicted)

    def attach_goodput(self, ledger) -> None:
        """Point /debug/goodput at the agent's GoodputLedger
        (goodput.py); the endpoint answers 503 until attached, like
        /debug/allocations and /debug/timeline."""
        self._goodput = ledger

    def attach_serving(self, status_fn) -> None:
        """Export a live serving engine's stats()
        (workloads/serving.py) as the elastic_tpu_serving_* gauges.
        ``status_fn`` is read at scrape time via set_function — a
        broken engine reads as 0s, never a failed scrape."""

        def read(*path):
            def _read() -> float:
                try:
                    node = status_fn() or {}
                    for key in path[:-1]:
                        node = node.get(key) or {}
                    value = node.get(path[-1])
                    return float(value) if value is not None else 0.0
                except Exception:  # noqa: BLE001 - scrape never breaks
                    return 0.0
            return _read

        self.serving_pool_blocks.set_function(read("pool_blocks"))
        self.serving_pool_used.set_function(read("used_blocks"))
        self.serving_prefilled_tokens.set_function(
            read("prefilled_tokens_total")
        )
        self.serving_admitted_tokens.set_function(
            read("admitted_tokens_total")
        )
        self.serving_prefix_cache_hits.set_function(
            read("prefix_cache", "hits")
        )
        self.serving_prefix_cache_misses.set_function(
            read("prefix_cache", "misses")
        )
        self.serving_prefix_cache_evictions.set_function(
            read("prefix_cache", "evictions")
        )
        self.serving_prefix_cache_hit_rate.set_function(
            read("prefix_cache", "hit_rate")
        )
        # Disaggregated roles (serving.disaggregated_status): absent
        # blocks read as 0, so a unified engine's status needs no shape
        # change and the role series stay flat until roles exist.
        for role in ("prefill", "decode"):
            self.serving_role_queue_depth.labels(role=role).set_function(
                read("roles", role, "queue_depth")
            )
        self.serving_pool_adoptions.set_function(
            read("shared_pool", "adoptions")
        )
        self.serving_pool_adopted_tokens.set_function(
            read("shared_pool", "adopted_tokens")
        )
        # Speculative + MoE blocks appear in stats() only when the
        # engine runs those workloads; read() yields 0 otherwise.
        self.serving_spec_drafted.set_function(
            read("speculative", "drafted_tokens")
        )
        self.serving_spec_accepted.set_function(
            read("speculative", "accepted_tokens")
        )
        self.serving_spec_acceptance_rate.set_function(
            read("speculative", "acceptance_rate")
        )
        self.serving_moe_imbalance.set_function(
            read("moe", "imbalance")
        )
        self.serving_moe_dropped.set_function(
            read("moe", "dropped_tokens")
        )

    def attach_requests(self, observatory) -> None:
        """Wire a RequestObservatory (workloads/request_obs.py) both
        ways: the observatory observes its TTFT/TPOT/phase histograms
        at source through us, and /debug/requests plus the request
        gauges read its ledgers at scrape. 503 until attached, like
        the other late-bound debug surfaces."""
        self._requests = observatory
        observatory.bind_metrics(self)

        self.requests_live.set_function(
            lambda: float(observatory.live_count)
        )
        self.requests_pending_handoff.set_function(
            lambda: float(observatory.pending_handoff_count)
        )

        def attain(slo):
            def _read() -> float:
                try:
                    v = observatory.attainment(slo)
                    return -1.0 if v is None else float(v)
                except Exception:  # noqa: BLE001 - scrape never breaks
                    return -1.0
            return _read

        from .workloads.request_obs import SLO_CLASSES

        for slo in SLO_CLASSES:
            self.request_slo_attainment.labels(slo=slo).set_function(
                attain(slo)
            )

    def attach_storage(self, storage) -> None:
        """Export the checkpoint store's write/commit counters (group-
        commit amplification accounting) via set_function reads — the
        store's hot path never touches prometheus."""

        def read(key):
            def _read() -> float:
                try:
                    return float(storage.write_stats().get(key) or 0)
                except Exception:  # noqa: BLE001 - scrape never breaks
                    return 0.0
            return _read

        self.storage_writes.set_function(read("writes_total"))
        self.storage_commits.set_function(read("commits_total"))

    def attach_supervisor(self, supervisor) -> None:
        """Fold supervisor state into /healthz: any circuit-broken
        CRITICAL subsystem flips the endpoint to 503 so the DaemonSet
        liveness probe restarts the pod; degraded subsystems ride along
        in the JSON without failing the probe."""
        self._supervisor = supervisor

    def attach_sitter(self, sitter) -> None:
        """Expose pod-cache staleness: a long apiserver outage shows up
        as a growing sync age instead of silent cache rot."""
        self._sitter = sitter
        self.sitter_sync_age.set_function(
            lambda: (
                -1.0 if sitter.sync_age_s() is None else sitter.sync_age_s()
            )
        )

    def attach_latency(self, observatory, lag_tracker=None) -> None:
        """Point /debug/latency at the bind-phase observatory and (when
        given) the detection-lag tracker; 503 until attached, like the
        other late-bound debug surfaces."""
        self._latency = observatory
        if lag_tracker is not None:
            self._lag = lag_tracker

    def attach_profiler(self, profiler) -> None:
        """Point /debug/profile at the continuous sampling profiler and
        export its self-measured cost — the profiler's <=1% overhead
        contract is only honest if the overhead itself is scraped."""
        self._profiler = profiler

        def _overhead() -> float:
            try:
                return float(profiler.overhead_ratio())
            except Exception:  # noqa: BLE001 - scrape never breaks
                return 0.0

        self.profiler_overhead.set_function(_overhead)
        self.profiler_samples.set_function(
            lambda: float(profiler.samples_total)
        )

    def register_sink(self, sink) -> None:
        """Export a live AsyncSink's internals as gauges. Uses
        set_function so the scrape always reads current state — no
        update calls sprinkled through the sink's hot path."""
        name = sink.name
        self.sink_queue_depth.labels(sink=name).set_function(
            lambda: sink.queue_depth
        )
        if hasattr(sink, "merged"):
            self.sink_merged.labels(sink=name).set_function(
                lambda: float(sink.merged)
            )
        self.sink_consecutive_failures.labels(sink=name).set_function(
            lambda: sink.consecutive_failures
        )
        self.sink_disabled.labels(sink=name).set_function(
            lambda: float(sink.disabled)
        )
        # Real write traffic, counted at the source (async_sink invokes
        # on_write once per successfully drained op): the fleet
        # aggregator sums these instead of inferring apiserver load.
        if hasattr(sink, "on_write"):
            sink.on_write = self.sink_writes.labels(
                sink=SINK_LABELS.get(name, name)
            ).inc

    def observe_allocate(self, seconds: float) -> None:
        self.allocate_latency.observe(seconds)

    def observe_prestart(self, seconds: float) -> None:
        self.prestart_latency.observe(seconds)

    # -- the unified HTTP endpoint --------------------------------------------

    def serve(
        self,
        port: int,
        addr: str = DEFAULT_BIND_ADDR,
        tracer=None,
    ) -> ThreadingHTTPServer:
        """Start the observability endpoint on ``addr:port`` (port 0 =
        ephemeral, for tests; the bound server is returned and kept on
        self). ``tracer`` defaults to the process-wide tracing ring."""
        if tracer is None:
            from .tracing import get_tracer

            tracer = get_tracer()
        registry = self._registry
        agent_metrics = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 - silence stderr
                logger.debug("metrics http: " + fmt, *args)

            def _reply(self, code, content_type, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, payload, code=200) -> None:
                self._reply(
                    code, "application/json",
                    json.dumps(payload).encode(),
                )

            def _require_loopback(self) -> bool:
                # Debug dumps stay node-local even when the bind is
                # widened for Prometheus (--metrics-addr 0.0.0.0 on
                # hostNetwork): they name every pod/chip/device on the
                # node — not for cross-tenant eyes. Reach them via the
                # node shell or kubectl port-forward.
                parsed = urlparse(self.path)
                if self.client_address[0] in (
                    "127.0.0.1", "::1", "::ffff:127.0.0.1",
                ):
                    return True
                self._reply_json(
                    {"error": f"{parsed.path} is served to "
                              "loopback clients only"},
                    code=403,
                )
                return False

            def do_GET(self):  # noqa: N802
                # Self-observability: every request — scrape, debug
                # dump, probe, scanner noise — is timed and counted.
                # The path label is normalized to the known routes
                # ('other' for everything else) so a port scanner
                # cannot mint unbounded label values.
                t0 = time.monotonic()
                parsed = urlparse(self.path)
                try:
                    self._route(parsed)
                finally:
                    try:
                        norm = parsed.path.rstrip("/") or "/"
                        if norm not in (
                            "/metrics", "/healthz", "/debug",
                        ) and norm not in DEBUG_ROUTES:
                            norm = "other"
                        agent_metrics.scrape_requests.labels(
                            path=norm
                        ).inc()
                        agent_metrics.scrape_duration.observe(
                            time.monotonic() - t0
                        )
                    except Exception:  # noqa: BLE001 - never kill a reply
                        pass

            def _route(self, parsed) -> None:
                try:
                    if parsed.path == "/metrics":
                        self._reply(
                            200, CONTENT_TYPE_LATEST,
                            generate_latest(registry),
                        )
                    elif parsed.path == "/debug/traces":
                        if not self._require_loopback():
                            return
                        q = parse_qs(parsed.query)
                        pod = q.get("pod", [None])[0]
                        trace_id = q.get("trace", [None])[0]
                        limit = None
                        if q.get("limit"):
                            try:
                                limit = max(0, int(q["limit"][0]))
                            except ValueError:
                                self._reply_json(
                                    {"error": "limit must be an integer"},
                                    code=400,
                                )
                                return
                        self._reply_json({
                            "traces": tracer.dump(
                                pod=pod, limit=limit, trace_id=trace_id
                            ),
                            "completed_total": tracer.completed,
                            "capacity": tracer.capacity,
                        })
                    elif parsed.path == "/debug/timeline":
                        if not self._require_loopback():
                            return
                        timeline = agent_metrics._timeline
                        if timeline is None:
                            self._reply_json(
                                {"error": "lifecycle timeline not "
                                          "attached (agent starting)"},
                                code=503,
                            )
                            return
                        q = parse_qs(parsed.query)
                        params = {}
                        for name, key in (
                            ("pod", "pod"), ("slice", "slice_id"),
                            ("node", "node"), ("trace", "trace"),
                        ):
                            if q.get(name):
                                params[key] = q[name][0]
                        for name, key, cast in (
                            ("chip", "chip", int),
                            ("since", "since", float),
                            ("limit", "limit", int),
                        ):
                            if q.get(name):
                                try:
                                    params[key] = cast(q[name][0])
                                except ValueError:
                                    self._reply_json(
                                        {"error": f"{name} must be "
                                                  "numeric"},
                                        code=400,
                                    )
                                    return
                        if q.get("kind"):
                            params["kinds"] = q["kind"]
                        payload = timeline.status()
                        payload["events"] = timeline.events(**params)
                        self._reply_json(payload)
                    elif parsed.path == "/debug/goodput":
                        if not self._require_loopback():
                            return
                        ledger = agent_metrics._goodput
                        if ledger is None:
                            self._reply_json(
                                {"error": "goodput ledger not attached "
                                          "(agent starting)"},
                                code=503,
                            )
                            return
                        q = parse_qs(parsed.query)
                        pod = q.get("pod", [None])[0]
                        since = None
                        if q.get("since"):
                            try:
                                since = float(q["since"][0])
                            except ValueError:
                                self._reply_json(
                                    {"error": "since must be numeric"},
                                    code=400,
                                )
                                return
                        self._reply_json(
                            ledger.status(pod=pod, since=since)
                        )
                    elif parsed.path == "/debug/latency":
                        if not self._require_loopback():
                            return
                        latency = agent_metrics._latency
                        if latency is None:
                            self._reply_json(
                                {"error": "latency observatory not "
                                          "attached (agent starting)"},
                                code=503,
                            )
                            return
                        q = parse_qs(parsed.query)
                        top = None
                        if q.get("top"):
                            try:
                                top = max(1, int(q["top"][0]))
                            except ValueError:
                                self._reply_json(
                                    {"error": "top must be an integer"},
                                    code=400,
                                )
                                return
                        lag = agent_metrics._lag
                        self._reply_json({
                            "bind": latency.status(top=top),
                            "detection_lag": (
                                lag.status() if lag is not None else None
                            ),
                            "slow_span_ms": round(
                                tracer.slow_span_s * 1000, 3
                            ),
                        })
                    elif parsed.path == "/debug/profile":
                        if not self._require_loopback():
                            return
                        profiler = agent_metrics._profiler
                        if profiler is None:
                            self._reply_json(
                                {"error": "profiler not attached "
                                          "(agent starting)"},
                                code=503,
                            )
                            return
                        q = parse_qs(parsed.query)
                        top = 30
                        if q.get("top"):
                            try:
                                top = max(1, int(q["top"][0]))
                            except ValueError:
                                self._reply_json(
                                    {"error": "top must be an integer"},
                                    code=400,
                                )
                                return
                        self._reply_json(profiler.status(top=top))
                    elif parsed.path == "/debug/requests":
                        if not self._require_loopback():
                            return
                        observatory = agent_metrics._requests
                        if observatory is None:
                            self._reply_json(
                                {"error": "request observatory not "
                                          "attached (agent starting)"},
                                code=503,
                            )
                            return
                        q = parse_qs(parsed.query)
                        rid = None
                        limit = None
                        for name in ("id", "limit"):
                            if q.get(name):
                                try:
                                    val = max(0, int(q[name][0]))
                                except ValueError:
                                    self._reply_json(
                                        {"error": f"{name} must be "
                                                  "an integer"},
                                        code=400,
                                    )
                                    return
                                if name == "id":
                                    rid = val
                                else:
                                    limit = val
                        slo = q.get("slo", [None])[0]
                        if slo is not None:
                            from .workloads.request_obs import (
                                SLO_CLASSES,
                            )
                            if slo not in SLO_CLASSES:
                                self._reply_json(
                                    {"error": "slo must be one of "
                                              + "|".join(SLO_CLASSES)},
                                    code=400,
                                )
                                return
                        self._reply_json(observatory.status(
                            request_id=rid, slo=slo, limit=limit,
                        ))
                    elif parsed.path in ("/debug", "/debug/"):
                        if not self._require_loopback():
                            return
                        self._reply_json({"routes": DEBUG_ROUTES})
                    elif parsed.path == "/debug/allocations":
                        if not self._require_loopback():
                            return
                        sampler = agent_metrics._sampler
                        if sampler is None:
                            self._reply_json(
                                {"error": "utilization sampler not "
                                          "attached (agent starting, or "
                                          "sampling disabled)"},
                                code=503,
                            )
                            return
                        self._reply_json(sampler.allocations_snapshot())
                    elif parsed.path == "/healthz":
                        status = {
                            "status": "ok",
                            "traces_completed": tracer.completed,
                        }
                        code = 200
                        if agent_metrics._sampler is not None:
                            status["sampler_samples"] = (
                                agent_metrics._sampler.samples_total
                            )
                        sitter = agent_metrics._sitter
                        if sitter is not None:
                            status["sitter_sync_age_s"] = sitter.sync_age_s()
                        if agent_metrics._timeline is not None:
                            # Boot identity: restarts must be visible
                            # from the probe side too, not only inside
                            # journal histories.
                            status["boot_id"] = (
                                agent_metrics._timeline.boot_id
                            )
                        sup = agent_metrics._supervisor
                        if sup is not None:
                            snap = sup.healthz()
                            status["subsystems"] = snap["subsystems"]
                            status["degraded"] = snap["degraded"]
                            status["critical_failed"] = snap["critical_failed"]
                            if snap["critical_failed"]:
                                # the liveness-probe contract: a 503 here
                                # makes kubelet restart the whole pod —
                                # the only recovery once a critical loop
                                # is circuit-broken
                                status["status"] = "failing"
                                code = 503
                            elif snap["degraded"]:
                                status["status"] = "degraded"
                        self._reply_json(status, code=code)
                    elif parsed.path.startswith("/debug/"):
                        # Unknown debug paths answer an explicit JSON
                        # 404 naming the real routes instead of the
                        # generic catch-all — a typo'd surface should
                        # self-correct from its own error body.
                        self._reply_json(
                            {"error": f"no such debug path {parsed.path}",
                             "debug_routes": sorted(DEBUG_ROUTES)},
                            code=404,
                        )
                    else:
                        self._reply_json(
                            {"error": f"no such path {parsed.path}",
                             "paths": ["/metrics", "/debug",
                                       *sorted(DEBUG_ROUTES),
                                       "/healthz"]},
                            code=404,
                        )
                except BrokenPipeError:  # client went away mid-reply
                    pass
                except Exception:  # noqa: BLE001 - never kill the server
                    logger.exception("metrics http handler failed")
                    try:
                        self._reply_json(
                            {"error": "internal error"}, code=500
                        )
                    except Exception:  # noqa: BLE001
                        pass

        try:
            httpd = ThreadingHTTPServer((addr, port), Handler)
        except OSError as e:
            raise MetricsServerError(
                f"observability endpoint cannot bind {addr}:{port}: {e} "
                "(is another agent or exporter already listening? pass a "
                "different --metrics-port, or 0 to disable)"
            ) from e
        httpd.daemon_threads = True
        threading.Thread(
            target=httpd.serve_forever, daemon=True, name="metrics-http"
        ).start()
        self._httpd = httpd
        logger.info(
            "observability endpoint on %s:%d (/metrics /debug/traces "
            "/debug/allocations /debug/timeline /healthz)",
            addr, httpd.server_address[1],
        )
        return httpd

    def serve_with_retry(
        self,
        port: int,
        addr: str = DEFAULT_BIND_ADDR,
        retry_s: float = 15.0,
    ) -> Optional[ThreadingHTTPServer]:
        """serve(), but a bind failure starts a background retry loop
        instead of giving up. With the DaemonSet liveness probe hitting
        /healthz, permanently running without the endpoint would turn a
        transient port conflict (typically the previous agent pod still
        draining on hostNetwork) into an unfixable probe-restart loop;
        retrying binds as soon as the old holder releases the port.
        Returns the server, or None while the port is still contended."""
        try:
            return self.serve(port, addr=addr)
        except MetricsServerError as e:
            logger.error(
                "%s — agent continues, retrying the bind every %.0fs "
                "(liveness probes fail until it succeeds)", e, retry_s,
            )

        def _retry() -> None:
            while self._httpd is None:
                time.sleep(retry_s)
                try:
                    self.serve(port, addr=addr)
                    logger.info(
                        "observability endpoint recovered on %s:%d",
                        addr, port,
                    )
                    return
                except MetricsServerError:
                    continue

        threading.Thread(
            target=_retry, daemon=True, name="metrics-retry"
        ).start()
        return None

    @property
    def http_port(self) -> Optional[int]:
        """The bound port of the observability endpoint (None until
        serve(); useful with port 0)."""
        if self._httpd is None:
            return None
        return self._httpd.server_address[1]

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


# -- exposition-format lint (promtool-style, in-repo, no new dependency) ------
#
# `promtool check metrics` is the tool operators actually run against a
# scrape; CI cannot assume it exists in the image, so this is the same
# rule set as plain functions: every family with samples has HELP and
# TYPE (TYPE before the first sample), no duplicate series, sample
# lines grammatical, label values escaped per the exposition format
# (only \\ , \" and \n escapes are legal inside a quoted value).

_EXPO_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_EXPO_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_EXPO_VALUE_RE = re.compile(
    r"^(?:[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|NaN|[+-]?Inf)$"
)
_EXPO_TYPES = frozenset(
    {"counter", "gauge", "histogram", "summary", "untyped", "info"}
)
# A sample's family: its name minus the well-known generated suffixes
# (prometheus_client emits `x_total`/`x_created` under family `x`, and
# histogram `x_bucket`/`x_sum`/`x_count` under `x`).
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count", "_total", "_created",
                  "_gsum", "_gcount", "_info")


def _expo_parse_labels(raw: str):
    """Parse the `{...}` body of a sample line; returns (labels dict,
    error string or None). Hand-rolled so ESCAPING mistakes surface as
    lint problems instead of silently mis-parsing."""
    labels = {}
    i, n = 0, len(raw)
    while i < n:
        j = i
        while j < n and raw[j] not in "=":
            j += 1
        name = raw[i:j].strip()
        if not _EXPO_LABEL_NAME_RE.match(name):
            return labels, f"bad label name {name!r}"
        if j >= n or raw[j] != "=":
            return labels, f"label {name!r} missing '='"
        j += 1
        if j >= n or raw[j] != '"':
            return labels, f"label {name!r} value not quoted"
        j += 1
        value = []
        while j < n:
            ch = raw[j]
            if ch == "\\":
                if j + 1 >= n or raw[j + 1] not in ('\\', '"', 'n'):
                    return labels, (
                        f"label {name!r}: illegal escape "
                        f"\\{raw[j + 1] if j + 1 < n else ''!s}"
                    )
                value.append(raw[j:j + 2])
                j += 2
                continue
            if ch == '"':
                break
            value.append(ch)
            j += 1
        else:
            return labels, f"label {name!r} value unterminated"
        if name in labels:
            return labels, f"label {name!r} repeated"
        labels[name] = "".join(value)
        j += 1  # past closing quote
        if j < n:
            if raw[j] != ",":
                return labels, f"junk after label {name!r}: {raw[j:]!r}"
            j += 1
        i = j
    return labels, None


def _expo_family_of(sample_name: str, families) -> "Optional[str]":
    if sample_name in families:
        return sample_name
    for suffix in _EXPO_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families:
                return base
    return None


def lint_exposition(text: str) -> list:
    """Lint a /metrics payload; returns problems (empty = conformant).
    Consumed by the exposition-conformance test and usable against any
    scrape (`lint_exposition(urlopen(...).read().decode())`)."""
    problems = []
    helped, typed = set(), set()
    families_with_samples = {}
    seen_series = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue  # plain comment: legal
            name = parts[2]
            if not _EXPO_NAME_RE.match(name):
                problems.append(
                    f"line {lineno}: bad metric name {name!r} in "
                    f"{parts[1]}"
                )
                continue
            if parts[1] == "HELP":
                if name in helped:
                    problems.append(
                        f"line {lineno}: duplicate HELP for {name}"
                    )
                helped.add(name)
            else:
                if name in typed:
                    problems.append(
                        f"line {lineno}: duplicate TYPE for {name}"
                    )
                if len(parts) < 4 or parts[3] not in _EXPO_TYPES:
                    problems.append(
                        f"line {lineno}: TYPE {name} "
                        f"{parts[3] if len(parts) > 3 else ''!r} is not "
                        "a known type"
                    )
                if name in families_with_samples:
                    problems.append(
                        f"line {lineno}: TYPE for {name} after its "
                        "samples"
                    )
                typed.add(name)
            continue
        # sample line: name[{labels}] value [timestamp]
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                problems.append(f"line {lineno}: unbalanced braces")
                continue
            name = line[:brace]
            labels, err = _expo_parse_labels(line[brace + 1:close])
            if err:
                problems.append(f"line {lineno}: {err}")
            rest = line[close + 1:].strip()
        else:
            fields = line.split(None, 1)
            name = fields[0]
            labels = {}
            rest = fields[1].strip() if len(fields) > 1 else ""
        if not _EXPO_NAME_RE.match(name):
            problems.append(f"line {lineno}: bad sample name {name!r}")
            continue
        value_fields = rest.split()
        if not value_fields or not _EXPO_VALUE_RE.match(value_fields[0]):
            problems.append(
                f"line {lineno}: {name} sample value "
                f"{value_fields[0] if value_fields else ''!r} is not a "
                "number"
            )
        if len(value_fields) > 2:
            problems.append(
                f"line {lineno}: {name} trailing junk after value"
            )
        series = (name, tuple(sorted(labels.items())))
        if series in seen_series:
            problems.append(
                f"line {lineno}: duplicate series {name}"
                f"{dict(labels) if labels else ''}"
            )
        seen_series.add(series)
        family = _expo_family_of(name, typed | helped)
        if family is None:
            # a sample with neither HELP nor TYPE anywhere: flag once
            families_with_samples.setdefault(name, lineno)
            problems.append(
                f"line {lineno}: sample {name} has no HELP/TYPE family"
            )
        else:
            families_with_samples.setdefault(family, lineno)
    for family, lineno in sorted(families_with_samples.items()):
        if family in typed and family not in helped:
            problems.append(f"family {family} (line {lineno}) has no HELP")
        if family in helped and family not in typed:
            problems.append(f"family {family} (line {lineno}) has no TYPE")
    return problems
