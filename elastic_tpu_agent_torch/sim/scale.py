"""Cluster-in-a-box scale harness: thousand-pod fleet load generation.

The port's copy of ``elastic_tpu_agent/sim/scale.py``, over the port's
agents. The fleet observatory (fleet.py) proves N agents against one
apiserver *work*; this harness proves the write paths and memory bounds
HOLD at production pod counts. It is the load generator that composes
16-32 complete agents (full NodeManager each — supervised reconciler, drain
orchestrator, sinks, sampler) against ONE shared FakeAPIServer and
churns thousands of concurrent pods through deterministic scenario
phases:

1. **admission waves** — pods admitted and bound in W fleet-wide
   concurrent waves (the mass-reschedule shape: a big job landing);
2. **steady-state churn** — a fraction of the fleet's pods deleted
   (apiserver + kubelet, like the control plane would) and replaced,
   driving GC/reconcile traffic alongside fresh binds;
3. **drain wave** — maintenance announced on several nodes at once,
   then cleared: cordon/signal/cancel across the fleet mid-load;
4. **slice reform** — a multi-host slice forms and loses a member pod;
   survivors must re-form while the rest of the fleet churns;
5. **repartition ticks** — one controller policy pass per node, timed
   at fleet pod counts (the tick walks the store and the ledger);
6. **cardinality storm** — 10k+ distinct pod-series pushed through the
   real BoundedLabeledGauge guards, proving bounded series AND bounded
   RSS while everything above is still resident.

Everything it reports is measured the way production would measure it:
fleet bind p50/p99 from scraped histogram merges (aggregator.py),
request amplification from source-side counters (kubelet List counter,
sink write counters, the FakeAPIServer's own ``request_counts``,
storage commit counters), convergence from the reconciler's converged
timestamp, and memory from ``/proc/self/statm`` sampled continuously
for the peak.

The two enabling refactors it exists to measure — group-commit storage
batching (storage/batcher.py) and coalesced sink traffic (async_sink
flush window) — are knobs here, so one run with them and one without
gives a same-run write-amplification comparison.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..common import read_rss_bytes
from ..tracing import get_tracer
from .aggregator import FleetAggregator
from .fleet import FleetSim, PodRef


class RSSWatcher:
    """Samples this process's RSS on a background thread; keeps the
    peak. The scale run's memory ceiling is asserted against the PEAK,
    not a lucky end-of-run sample taken after the churn's garbage was
    collected."""

    def __init__(self, period_s: float = 0.05) -> None:
        self._period_s = period_s
        self._stop = threading.Event()
        self.start_bytes = read_rss_bytes()
        self.peak_bytes = self.start_bytes
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="scale-rss-watcher"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._period_s):
            rss = read_rss_bytes()
            if rss > self.peak_bytes:
                self.peak_bytes = rss

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=5.0)
        rss = read_rss_bytes()
        if rss > self.peak_bytes:
            self.peak_bytes = rss
        return {
            "start_rss_bytes": self.start_bytes,
            "peak_rss_bytes": self.peak_bytes,
            "rss_delta_bytes": max(0, self.peak_bytes - self.start_bytes),
        }


class ScaleHarness:
    """One scale scenario over one FleetSim. Build → run() → report.

    ``storage_batch_window_s`` / ``sink_flush_window_s`` select the
    batched (coalesced) or the historical per-write shape; running both
    gives the measured amplification reduction.
    """

    def __init__(
        self,
        base_dir: str,
        nodes: int = 16,
        pods_per_node: int = 125,
        admission_waves: int = 4,
        workers_per_node: int = 2,
        churn_fraction: float = 0.2,
        drain_nodes: int = 2,
        slice_world: int = 4,
        cardinality_series_total: int = 10_500,
        storage_batch_window_s: float = 0.005,
        sink_flush_window_s: float = 0.02,
        reconcile_period_s: float = 2.0,
        enable_sampler: bool = True,
        convergence_timeout_s: float = 120.0,
        phase_timeout_s: float = 120.0,
    ) -> None:
        self.nodes = nodes
        self.pods_per_node = pods_per_node
        self.admission_waves = max(1, admission_waves)
        self.workers_per_node = workers_per_node
        self.churn_fraction = churn_fraction
        self.drain_nodes = min(drain_nodes, nodes)
        self.slice_world = min(slice_world, nodes)
        self.cardinality_series_total = cardinality_series_total
        self.storage_batch_window_s = storage_batch_window_s
        self.sink_flush_window_s = sink_flush_window_s
        self.convergence_timeout_s = convergence_timeout_s
        self.phase_timeout_s = phase_timeout_s
        self.sim = FleetSim(
            base_dir,
            nodes=nodes,
            reconcile_period_s=reconcile_period_s,
            enable_sampler=enable_sampler,
            storage_batch_window_s=storage_batch_window_s,
            sink_flush_window_s=sink_flush_window_s,
        )

    # -- phases ---------------------------------------------------------------

    def _phase_admission_waves(self) -> dict:
        """W waves of fleet-wide concurrent admission + bind — the
        thundering-herd shape a mass reschedule produces."""
        sim = self.sim
        per_wave = max(1, self.pods_per_node // self.admission_waves)
        waves = []
        for w in range(self.admission_waves):
            count = (
                self.pods_per_node - per_wave * (self.admission_waves - 1)
                if w == self.admission_waves - 1 else per_wave
            )
            if count <= 0:
                continue
            refs = sim.admit_pods(count, namespace=f"wave{w}")
            sim.wait_synced(refs, timeout_s=self.phase_timeout_s)
            driver = sim.churn(
                refs, workers_per_node=self.workers_per_node,
                timeout_s=self.phase_timeout_s * 4,
            )
            waves.append({
                "pods": driver["pods"],
                "bound": driver["bound"],
                "error_count": driver["error_count"],
                "bind_p50_ms": driver["bind_p50_ms"],
                "bind_p99_ms": driver["bind_p99_ms"],
                "binds_per_s": driver["binds_per_s"],
            })
            self._refs.extend(refs)
            self._last_churn_end_ts = driver["churn_end_ts"]
        return {
            "waves": waves,
            "admitted": sum(w["pods"] for w in waves),
            "bound": sum(w["bound"] for w in waves),
            "errors": sum(w["error_count"] for w in waves),
        }

    def _phase_steady_churn(self) -> dict:
        """Delete a fraction of the live fleet (control-plane style:
        apiserver DELETE + kubelet unassign), wait for the GC/reconcile
        machinery to reclaim every binding, then admit and bind
        replacements — the steady-state pod-lifecycle load."""
        sim = self.sim
        stride = max(2, int(1 / max(0.01, self.churn_fraction)))
        victims = self._refs[::stride]
        if not victims:
            return {"skipped": True, "reason": "no pods admitted"}
        t0 = time.perf_counter()
        sim.delete_pods(victims)
        reclaim_s = sim.wait_reclaimed(
            victims, timeout_s=self.phase_timeout_s
        )
        victim_keys = {id(v) for v in victims}
        self._refs = [r for r in self._refs if id(r) not in victim_keys]
        # Replacements: same per-node counts the victims had.
        by_node: Dict[int, int] = {}
        for v in victims:
            by_node[v.node_idx] = by_node.get(v.node_idx, 0) + 1
        replacements: List[PodRef] = []
        for idx, count in sorted(by_node.items()):
            replacements.extend(sim.admit_pods(
                count, namespace="replace", node_idxs=[idx]
            ))
        sim.wait_synced(replacements, timeout_s=self.phase_timeout_s)
        driver = sim.churn(
            replacements, workers_per_node=self.workers_per_node,
            timeout_s=self.phase_timeout_s * 2,
        )
        self._refs.extend(replacements)
        self._last_churn_end_ts = driver["churn_end_ts"]
        return {
            "deleted": len(victims),
            "reclaim_wait_s": round(reclaim_s, 3),
            "replaced": driver["pods"],
            "rebound": driver["bound"],
            "errors": driver["error_count"],
            "rebind_p99_ms": driver["bind_p99_ms"],
            "wall_s": round(time.perf_counter() - t0, 3),
        }

    def _phase_drain_wave(self) -> dict:
        """Maintenance announced on ``drain_nodes`` nodes AT ONCE (a
        rack maintenance window), then cleared: every one must cordon
        and signal, then cancel back to active — while the rest of the
        fleet keeps its pods."""
        sim = self.sim
        idxs = list(range(self.nodes - self.drain_nodes, self.nodes))
        if not idxs:
            return {"skipped": True, "reason": "no drain nodes configured"}
        t0 = time.perf_counter()
        for i in idxs:
            sim.trigger_maintenance(i)
        states = {}
        for i in idxs:
            states[sim.nodes[i].name] = sim.wait_drain_state(
                i, ("cordoned", "draining", "drained"),
                timeout_s=self.phase_timeout_s,
            )
        signal_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for i in idxs:
            sim.clear_maintenance(i)
        for i in idxs:
            sim.wait_drain_state(i, "active", timeout_s=self.phase_timeout_s)
        return {
            "nodes": len(idxs),
            "states_reached": states,
            "all_signaled_s": round(signal_s, 3),
            "all_cancelled_s": round(time.perf_counter() - t1, 3),
        }

    def _phase_slice_reform(self) -> dict:
        """A multi-host slice forms across ``slice_world`` nodes, binds,
        then loses one member POD (deleted at the apiserver, the node
        stays up): survivors must re-form to the smaller world while the
        fleet around them is fully loaded."""
        from ..common import EnvSliceEpoch  # noqa: F401 - doc pointer
        from ..slice_env import ordered_worker_hostnames

        sim = self.sim
        node_idxs = list(range(self.slice_world))
        hosts = [sim.nodes[i].name for i in node_idxs]
        t0 = time.perf_counter()
        refs = sim.admit_slice("scale-slice", node_idxs)
        sim.wait_synced(refs, timeout_s=self.phase_timeout_s)
        for ref in refs:
            sim.bind_pod(ref)
        formation_s = time.perf_counter() - t0
        victim, survivors = refs[-1], refs[:-1]
        surviving_order, _ = ordered_worker_hostnames(hosts[:-1])
        sim.delete_pods([victim])
        reform_s = sim.wait_slice_reformed(
            survivors, surviving_order, expected_epoch=1,
            timeout_s=self.phase_timeout_s,
        )
        # The victim's binding must also be RECLAIMED (GC off the
        # sitter's DELETED event), so the fleet's stored-bind ground
        # truth stays exact; survivors stay resident and counted.
        sim.wait_reclaimed([victim], timeout_s=self.phase_timeout_s)
        self._refs.extend(survivors)
        return {
            "world": len(refs),
            "formation_s": round(formation_s, 3),
            "reform_convergence_s": round(reform_s, 3),
        }

    def _phase_repartition_ticks(self) -> dict:
        """One repartition-controller policy pass per node, timed: the
        tick diffs the sampler view against the store and the donation
        ledger — at fleet pod counts its cost is a per-node scaling
        number, not a constant."""
        sim = self.sim
        durations = []
        for node in sim.nodes:
            controller = getattr(node.manager, "repartition", None)
            if controller is None:
                return {
                    "skipped": True,
                    "reason": "repartition controller disabled "
                              "(sampler off)",
                }
            t0 = time.perf_counter()
            try:
                controller.tick()
            except Exception as e:  # noqa: BLE001 - reported, not fatal
                return {
                    "failed": True,
                    "error": f"{node.name}: {type(e).__name__}: {e}",
                }
            durations.append(time.perf_counter() - t0)
        durations.sort()
        return {
            "ticks": len(durations),
            "tick_p50_ms": round(durations[len(durations) // 2] * 1000, 3),
            "tick_max_ms": round(durations[-1] * 1000, 3),
        }

    def _phase_cardinality_storm(self) -> dict:
        """Push 10k+ distinct pod-series through every node's REAL
        bounded gauges (the sampler's export path) while the whole
        fleet is resident: the per-node series count must hold at the
        cap, eviction accounting must add up, and the RSS watcher
        running over this phase is what the memory ceiling is asserted
        against."""
        sim = self.sim
        per_node = max(1, self.cardinality_series_total // self.nodes)
        problems: List[str] = []
        total_inserted = 0
        for node in sim.nodes:
            gauge = node.metrics.pod_core_used
            before_count = gauge.series_count
            for i in range(per_node):
                gauge.set(float(i % 97), pod=f"storm/p-{i}")
            total_inserted += per_node
            cap = gauge._max
            if gauge.series_count > cap:
                problems.append(
                    f"{node.name}: {gauge.series_count} series > cap {cap}"
                )
            # eviction accounting: at least (inserted + pre-existing -
            # cap) series must have been counted out (the sampler may
            # be inserting concurrently, so >= not ==; exact accounting
            # is pinned single-writer in tests/test_cardinality.py)
            expect_evicted = before_count + per_node - cap
            if expect_evicted > 0:
                evicted = node.metrics.series_evicted._value.get()
                if evicted < expect_evicted:
                    problems.append(
                        f"{node.name}: evicted counter {evicted} < "
                        f"expected >= {expect_evicted}"
                    )
        return {
            "series_inserted": total_inserted,
            "per_node": per_node,
            "problems": problems,
        }

    # -- the run --------------------------------------------------------------

    def run(self) -> dict:
        self._refs: List[PodRef] = []
        self._last_churn_end_ts: Optional[float] = None
        watcher = RSSWatcher()
        sim = self.sim
        t_start = time.perf_counter()
        sim.start()
        startup_s = time.perf_counter() - t_start
        try:
            agg = FleetAggregator(sim.targets())
            phases = {}
            phases["admission_waves"] = self._phase_admission_waves()
            phases["steady_churn"] = self._phase_steady_churn()
            phases["drain_wave"] = self._phase_drain_wave()
            phases["slice_reform"] = self._phase_slice_reform()
            phases["repartition_ticks"] = self._phase_repartition_ticks()
            phases["cardinality_storm"] = self._phase_cardinality_storm()
            # Convergence measured from the LAST churn's end: every node
            # must reach a fully-converged reconcile pass with the whole
            # scenario's state resident.
            anchor = self._last_churn_end_ts or time.time()
            convergence = agg.convergence_summary(agg.wait_converged(
                anchor, timeout_s=self.convergence_timeout_s,
            ))
            rollup = agg.rollup()
            stored = sim.stored_binds()
            storage_stats = [
                node.storage.write_stats() for node in sim.nodes
            ]
            sink_stats = self._sink_stats()
            timeline_rows = sum(
                node.storage.timeline_count() for node in sim.nodes
            )
            timeline_evicted = sum(
                node.storage.timeline_evicted_total()
                for node in sim.nodes
            )
            # Goodput rollup: force a fresh ledger replay everywhere,
            # then read the fleet SLI through the aggregator — the
            # scale story must price its drain wave / reform /
            # repartition churn in downtime-by-cause, not just latency.
            sim.tick_goodput()
            fleet_goodput = agg.fleet_goodput()
            # Snapshot source-side counters BEFORE stop(): stop drops
            # the apiserver and swaps the sim's big trace ring back out.
            api_counts = dict(sim.apiserver.request_counts)
            api_total = sim.apiserver.requests_total()
            trace_ring_bytes = get_tracer().ring_bytes()
        finally:
            sim.stop()
        memory = watcher.stop()
        fleet = rollup["fleet"]
        binds = fleet["binds_total"] or 0
        storage_writes = sum(s["writes_total"] for s in storage_stats)
        storage_commits = sum(s["commits_total"] for s in storage_stats)
        # Series resident at peak: bounded gauges hold <= cap each, but
        # the CEILING is asserted against what was DRIVEN through the
        # process — the 10k+ storm plus two series per bound pod.
        series_driven = (
            phases["cardinality_storm"].get("series_inserted", 0)
            + 2 * len(self._refs)
        )
        rss_delta = memory["rss_delta_bytes"]
        return {
            "nodes": self.nodes,
            "pods": len(self._refs),
            "pods_per_node": self.pods_per_node,
            "startup_s": round(startup_s, 3),
            "batching": {
                "storage_batch_window_s": self.storage_batch_window_s,
                "sink_flush_window_s": self.sink_flush_window_s,
            },
            "phases": phases,
            "fleet_bind_p50_ms": fleet["fleet_bind_p50_ms"],
            "fleet_bind_p99_ms": fleet["fleet_bind_p99_ms"],
            "goodput": {
                **fleet_goodput["fleet"],
                "conservation_problems": (
                    fleet_goodput["conservation_problems"]
                ),
                "unreachable_nodes": fleet_goodput["unreachable"],
            },
            "binds_total": binds,
            "stored_binds": sum(stored.values()),
            "reconcile_convergence_s": convergence,
            "amplification": {
                "kubelet_lists_per_bind": (
                    fleet["request_amplification"]["kubelet_lists_per_bind"]
                ),
                "sink_writes_per_bind": (
                    fleet["request_amplification"]["sink_writes_per_bind"]
                ),
                "apiserver_requests_total": api_total,
                "apiserver_requests_per_bind": (
                    round(api_total / binds, 4) if binds else None
                ),
                "apiserver_request_counts": api_counts,
                "storage_writes_total": storage_writes,
                "storage_commits_total": storage_commits,
                "storage_commits_per_bind": (
                    round(storage_commits / binds, 4) if binds else None
                ),
                "storage_writes_per_commit": (
                    round(storage_writes / storage_commits, 3)
                    if storage_commits else None
                ),
                "sink": sink_stats,
            },
            "memory": {
                **memory,
                "series_driven": series_driven,
                "rss_delta_per_series_bytes": (
                    round(rss_delta / series_driven, 1)
                    if series_driven else None
                ),
                "trace_ring_bytes": trace_ring_bytes,
                "timeline_rows_total": timeline_rows,
                "timeline_evicted_total": timeline_evicted,
            },
        }

    def _sink_stats(self) -> dict:
        """Fleet-summed sink coalescing counters, read from the live
        recorders (merged = apiserver writes the coalescing window
        saved; dropped = queue-bound losses)."""
        out = {"writes": 0, "merged": 0, "dropped": 0}
        for node in self.sim.nodes:
            for rec in (node.manager.crd_recorder, node.manager.events):
                sink = getattr(rec, "_sink", None)
                if sink is None:
                    continue
                out["writes"] += sink.writes_total
                out["merged"] += sink.merged
                out["dropped"] += sink.dropped
        return out


def scale_problems(report: dict, bounds: Optional[dict] = None) -> List[str]:
    """Structural assertions over a scale OR chaos report (shared by the
    smokes and the tests).

    Scale reports (ScaleHarness.report()): every bind lands, every node
    converges, request amplification stays within bound, memory holds
    its documented ceiling. Chaos reports (sim/chaos.py ScenarioRunner)
    carry a ``compound`` block instead, judged by the compound-scenario
    invariants: no stream drops or resets client-visibly, no bind
    double-lands, goodput/request-phase conservation holds through
    arbitrary fault overlap, every handoff is adopted, every open
    intent resolves, and no node replays a reclaimed bind. Returns
    problems (empty = the run held)."""
    b = {
        # kubelet Lists per bind: the fleet leg measures ~0.9; 2.0 is
        # the regression alarm, not the target.
        "kubelet_lists_per_bind": 2.0,
        # async sink writes per bind, per sink (events ~1, CRD ~1-2).
        "sink_writes_per_bind": 4.0,
        # apiserver requests per bind across ALL kinds (sink writes +
        # membership lists + GC gets).
        "apiserver_requests_per_bind": 6.0,
        # documented memory ceiling: RSS growth per driven pod-series
        # (the agent's docs/operations.md "Scale & capacity planning").
        "rss_delta_per_series_bytes": 64 * 1024,
        # the trace ring is capacity-bounded; its bytes must stay small
        # against the process (64 MiB is far past any healthy ring).
        "trace_ring_bytes": 64 * 1024 * 1024,
        # compound-scenario invariants (chaos reports): request-phase
        # conservation residual ceiling, and optional score floors a
        # smoke can raise (None = not enforced).
        "worst_residual_s": 0.05,
        "min_goodput_percent": None,
        "min_slo_attainment": None,
        **(bounds or {}),
    }
    problems: List[str] = []
    if "compound" in report:
        problems += _compound_problems(report, b)
        gp = report.get("goodput", {})
        if gp.get("goodput_percent") is None:
            problems.append("goodput: fleet rollup missing")
        for p in gp.get("conservation_problems", []):
            problems.append(f"goodput conservation: {p}")
        return problems
    phases = report.get("phases", {})
    adm = phases.get("admission_waves", {})
    if adm.get("bound") != adm.get("admitted") or adm.get("errors"):
        problems.append(
            f"admission waves: {adm.get('bound')}/{adm.get('admitted')} "
            f"bound, {adm.get('errors')} error(s)"
        )
    churn = phases.get("steady_churn", {})
    if not churn.get("skipped") and (
        churn.get("rebound") != churn.get("replaced") or churn.get("errors")
    ):
        problems.append(f"steady churn: {churn}")
    for name in ("drain_wave", "slice_reform", "repartition_ticks"):
        phase = phases.get(name, {})
        if phase.get("failed") or phase.get("problems"):
            problems.append(f"{name}: {phase}")
    storm = phases.get("cardinality_storm", {})
    for p in storm.get("problems", []):
        problems.append(f"cardinality storm: {p}")
    if report.get("stored_binds") != report.get("pods"):
        problems.append(
            f"stored binds {report.get('stored_binds')} != live pods "
            f"{report.get('pods')}"
        )
    conv = report.get("reconcile_convergence_s", {})
    if conv.get("unconverged_nodes"):
        problems.append(
            f"unconverged nodes: {conv['unconverged_nodes']}"
        )
    amp = report.get("amplification", {})
    checks = [
        ("kubelet_lists_per_bind", amp.get("kubelet_lists_per_bind")),
        ("apiserver_requests_per_bind",
         amp.get("apiserver_requests_per_bind")),
    ]
    for sink, value in (amp.get("sink_writes_per_bind") or {}).items():
        checks.append((f"sink_writes_per_bind ({sink})", value))
    for label, value in checks:
        bound_key = label.partition(" ")[0]
        if value is None:
            problems.append(f"{label}: missing")
        elif value > b[bound_key]:
            problems.append(f"{label}: {value} > bound {b[bound_key]}")
    mem = report.get("memory", {})
    per_series = mem.get("rss_delta_per_series_bytes")
    if per_series is None:
        problems.append("memory: rss_delta_per_series_bytes missing")
    elif per_series > b["rss_delta_per_series_bytes"]:
        problems.append(
            f"memory: {per_series} B/series > ceiling "
            f"{b['rss_delta_per_series_bytes']}"
        )
    ring = mem.get("trace_ring_bytes", 0)
    if ring > b["trace_ring_bytes"]:
        problems.append(
            f"trace ring {ring} B > bound {b['trace_ring_bytes']}"
        )
    if not report.get("fleet_bind_p99_ms"):
        problems.append("fleet bind p99 missing from scraped histograms")
    gp = report.get("goodput", {})
    if gp.get("goodput_percent") is None:
        problems.append("goodput: fleet rollup missing")
    for p in gp.get("conservation_problems", []):
        problems.append(f"goodput conservation: {p}")
    return problems


def _compound_problems(report: dict, b: dict) -> List[str]:
    """The compound-scenario invariant set (chaos reports): what must
    hold through ARBITRARY fault overlap, judged after recovery."""
    problems: List[str] = []
    c = report["compound"]
    streams = c.get("streams", {})
    if streams.get("admitted") != streams.get("finished"):
        problems.append(
            f"stream conservation: {streams.get('admitted')} admitted "
            f"!= {streams.get('finished')} finished"
        )
    for key in ("live_leftover", "pending_handoff_leftover"):
        if streams.get(key):
            problems.append(f"streams: {streams[key]} {key}")
    if streams.get("client_visible_drops"):
        problems.append(
            f"client-visible stream drops: "
            f"{streams['client_visible_drops']} "
            f"(reasons: {streams.get('finish_reasons')})"
        )
    h = c.get("handoffs", {})
    if h.get("published") != h.get("adopted", 0) + h.get("expired", 0):
        problems.append(
            f"handoffs: {h.get('published')} published != "
            f"{h.get('adopted')} adopted + {h.get('expired')} expired"
        )
    if h.get("expired"):
        problems.append(f"handoffs: {h['expired']} expired unadopted")
    residual = abs(c.get("worst_residual_s") or 0.0)
    if residual > b["worst_residual_s"]:
        problems.append(
            f"request-phase conservation: worst residual {residual}s > "
            f"{b['worst_residual_s']}s"
        )
    tokens = c.get("tokens", {})
    if tokens.get("emitted") != tokens.get("accounted"):
        problems.append(
            f"token conservation: {tokens.get('emitted')} emitted != "
            f"{tokens.get('accounted')} accounted"
        )
    binds = c.get("binds", {})
    if binds.get("double_lands"):
        problems.append(f"bind double-lands: {binds['double_lands']}")
    if binds.get("records_missing"):
        problems.append(
            f"serve binds missing after recovery: "
            f"{binds['records_missing']}"
        )
    if c.get("open_intents"):
        problems.append(
            f"open intents unresolved: {c['open_intents']}"
        )
    rec = report.get("recovery", {})
    if rec.get("binds_never_landed"):
        problems.append(
            f"binds never landed: {rec['binds_never_landed']}"
        )
    if rec.get("reclaimed_bind_replays"):
        problems.append(
            f"reclaimed binds replayed: "
            f"{rec['reclaimed_bind_replays']}"
        )
    if rec.get("reclaim_error"):
        problems.append(f"reclaim: {rec['reclaim_error']}")
    for p in rec.get("problems", []) or []:
        problems.append(f"recovery: {p}")
    floor = b.get("min_goodput_percent")
    gp = (report.get("goodput") or {}).get("goodput_percent")
    if floor is not None and (gp is None or gp < floor):
        problems.append(f"goodput {gp}% < floor {floor}%")
    att_floor = b.get("min_slo_attainment")
    if att_floor is not None:
        for slo, block in (report.get("slo") or {}).items():
            att = block.get("attainment")
            if att is not None and att < att_floor:
                problems.append(
                    f"SLO {slo} attainment {att} < floor {att_floor}"
                )
    return problems
