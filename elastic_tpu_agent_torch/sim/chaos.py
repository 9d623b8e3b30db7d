"""Compound-fault chaos matrix: overlapping faults, scored by goodput.

The port's copy of ``elastic_tpu_agent/sim/chaos.py``, over fleets of the
port's agents. Schedules are pure data and equal the agent's on the same
seeds; the repro line keeps the agent's format and names the port's own
replay command (``python -m elastic_tpu_agent_torch.sim``), and the
throttle drive counts and retries a controller tick that the program's
flush fault failed, where the agent's sim lets it end the run.

Every fault the fleet survives in the scripted scenarios is injected
one at a time; the failures that reach production are the ones that
*compose* — a maintenance drain while the apiserver is browned out
while the storage batcher's disk is flaky, under a flash crowd. This
module turns the existing fault surfaces into a composable, seeded
vocabulary and replays them OVER live trace-driven traffic
(sim/traffic.py), so conservation invariants and fleet SLIs are checked
through arbitrary fault overlap rather than around hand-picked gaps.

Three layers, deliberately separated:

- :class:`ChaosProgram` — *pure data*. ``generate(seed, ...)`` draws a
  schedule of overlapping fault windows from one ``random.Random``
  stream; ``ops()`` compiles it to a start/stop timeline; ``lines()``/
  ``digest()`` are canonical bytes. Nothing here touches a clock or a
  fleet, which is what makes "same ``(trace_seed, chaos_seed)`` ⇒ same
  schedule" a byte-level guarantee, testable on a ManualClock.
- :class:`ScenarioRunner` — the executor: replays one trace + one
  program against a RUNNING FleetSim through the real admission paths
  (apiserver pod upserts, kubelet-shaped binds, RequestObservatory
  lifecycles with real cross-node handoff stitching on drain), then
  heals everything and scores the run with
  ``FleetAggregator.fleet_goodput()`` / ``fleet_slo()``. The report's
  ``compound`` block carries the conservation ledger that
  ``scale_problems()`` (sim/scale.py) judges: no client-visible stream
  drop, no bind double-land, every handoff adopted, every open intent
  resolved, request-phase residual ~0, goodput conservation clean.
- :class:`ChaosMatrix` — a bounded seeded scenario set plus the
  known-bad self-test (``sabotage``) that proves the checker trips.

Fault vocabulary (all composable, all reproducible from the seed):

=====================  ====================================================
``apiserver_brownout``  FakeAPIServer.set_brownout: seeded per-op 503
                        rate + latency window, healed at window end.
``failpoint``           faults.py registry window: arm ``point=spec`` at
                        start, disarm at end — brownout kinds
                        (``prob:``/``delay-range:``) compose here.
``maintenance_drain``   maintenance notice on one node; its open
                        streams hand off to a survivor (the real
                        handoff_begin/adopt stitching), cleared at end.
``preemption``          spot preemption notice (never un-rings).
``kubelet_flap``        FakeKubelet.restart_registration(): socket torn
                        down and recreated; the agent must re-register.
``throttle``            the real usage-report → sampler → repartition
                        loop clamps a seeded hog pod for the window.
=====================  ====================================================

On any invariant violation the report carries a one-line repro:
``python -m elastic_tpu_agent_torch.sim --trace-seed S --chaos-seed C
--scenario NAME``, which replays that scenario of the default matrix
(``sim/__main__.py``).
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Dict, Iterator, List, Optional

from .. import faults
from ..common import SYSTEM_CLOCK, Clock
from .traffic import Trace, TraceCursor, TraceGenerator

# Finish reasons the client SEES as a broken stream. Everything a
# healthy compound scenario produces must finish outside this set —
# a drained node's streams migrate (handoff/adopt), they do not drop.
CLIENT_VISIBLE_DROP_REASONS = frozenset(
    {"dropped", "reset", "evicted", "handoff_expired"}
)

# Per-block token share of a prompt (prefill cache attribution): chains
# are CHAIN_DEPTH blocks deep, cached tokens = hit blocks * share.
_TOKENS_PER_BLOCK_DIV = 8  # == traffic.CHAIN_DEPTH

# Synthetic decode pacing (seconds): small enough that scenarios finish
# in seconds, non-zero so streams stay OPEN across fault windows.
_SERVICE_FLOOR_S = 0.02
_PER_TOKEN_S = 0.0004

# The command that replays one scenario of the matrix (sim/__main__.py).
REPRO_COMMAND = "python -m elastic_tpu_agent_torch.sim"


def repro_line(trace_seed: int, chaos_seed: int, scenario: str) -> str:
    """The one-line repro printed on any failure."""
    return (
        f"{REPRO_COMMAND} --trace-seed {trace_seed} "
        f"--chaos-seed {chaos_seed} --scenario {scenario}"
    )


class ChaosProgram:
    """One seeded schedule of overlapping fault actions (pure data)."""

    def __init__(self, seed: int, actions: List[dict], meta: Dict) -> None:
        self.seed = seed
        self.actions = actions
        self.meta = meta

    # -- canonical serialization (determinism contract) -------------------

    def lines(self) -> List[str]:
        return [
            json.dumps(a, sort_keys=True, separators=(",", ":"))
            for a in self.actions
        ]

    def digest(self) -> str:
        h = hashlib.sha256()
        for line in self.lines():
            h.update(line.encode())
            h.update(b"\n")
        return h.hexdigest()[:16]

    # -- start/stop timeline ----------------------------------------------

    def ops(self) -> List[dict]:
        """Compile actions to a flat start/stop timeline: windowed
        actions yield two ops, instant ones a single ``start``. Sorted
        by time (stable tie-break on action id) — the schedule a
        ManualClock test steps through."""
        out: List[dict] = []
        for i, a in enumerate(self.actions):
            out.append({"t": a["t"], "op": "start", "id": i, "action": a})
            if a.get("duration_s"):
                out.append({
                    "t": round(a["t"] + a["duration_s"], 6),
                    "op": "stop", "id": i, "action": a,
                })
        out.sort(key=lambda o: (o["t"], o["id"], o["op"] == "start"))
        return out

    def end_t(self) -> float:
        return max(
            (a["t"] + a.get("duration_s", 0.0) for a in self.actions),
            default=0.0,
        )

    def overlaps(self) -> int:
        """How many action pairs overlap in time — the 'compound' in
        compound-fault; generate() guarantees at least one."""
        n = 0
        for i, a in enumerate(self.actions):
            a_end = a["t"] + a.get("duration_s", 0.0)
            for b in self.actions[i + 1:]:
                if b["t"] < a_end and a["t"] < b["t"] + b.get(
                    "duration_s", 0.0
                ):
                    n += 1
        return n

    # -- generation --------------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        duration_s: float = 4.0,
        nodes: int = 2,
        intensity: float = 1.0,
        include_drain: bool = True,
        include_throttle: bool = False,
        include_preemption: bool = False,
    ) -> "ChaosProgram":
        """Draw a schedule of overlapping fault windows from one seeded
        stream. Windows are long relative to the scenario (30-60%), so
        overlap is the common case; if the draw happens to produce a
        disjoint schedule, the second action is pulled into the first's
        window — compound by construction, still a pure function of the
        seed."""
        rng = random.Random(seed)
        acts: List[dict] = []

        def window(frac_lo: float, frac_hi: float):
            dur = duration_s * rng.uniform(frac_lo, frac_hi)
            start = rng.uniform(0.0, max(duration_s - dur, 1e-6))
            return round(start, 6), round(dur, 6)

        # Always: an apiserver brownout (the fleet's loudest shared
        # dependency) and a flaky group-commit disk.
        t, d = window(0.3, 0.6)
        acts.append({
            "kind": "apiserver_brownout", "t": t, "duration_s": d,
            "error_rate": round(rng.uniform(0.15, 0.35), 4),
            "latency_s": round(rng.uniform(0.0, 0.005), 6),
            "seed": rng.randrange(1 << 30),
        })
        t, d = window(0.3, 0.6)
        acts.append({
            "kind": "failpoint", "t": t, "duration_s": d,
            "point": "storage.batch_flush",
            "spec": f"prob:{round(rng.uniform(0.05, 0.2), 4)}"
                    f":{rng.randrange(1 << 30)}",
        })
        # Jittery-slow kubelet pod-resources answers.
        t, d = window(0.2, 0.5)
        acts.append({
            "kind": "failpoint", "t": t, "duration_s": d,
            "point": "podresources.list",
            "spec": f"delay-range:0.001:0.02:{rng.randrange(1 << 30)}",
        })
        if include_drain and nodes >= 2:
            t, d = window(0.25, 0.45)
            drain_node = rng.randrange(1, nodes)
            acts.append({
                "kind": "maintenance_drain", "t": t, "duration_s": d,
                "node": drain_node,
            })
            if include_preemption:
                # the migration killer compound: the host backing the
                # DRAINING node rings a spot-preemption notice mid-
                # window, so the pre-copy/cutover budget clamps to the
                # shorter horizon while its streams are handing off
                acts.append({
                    "kind": "preemption",
                    "t": round(t + d * rng.uniform(0.25, 0.5), 6),
                    "node": drain_node,
                })
        elif include_preemption and nodes >= 2:
            t, _ = window(0.25, 0.45)
            acts.append({
                "kind": "preemption", "t": t,
                "node": rng.randrange(1, nodes),
            })
        if include_throttle:
            t, d = window(0.25, 0.45)
            acts.append({
                "kind": "throttle", "t": t, "duration_s": d, "node": 0,
            })
        # A kubelet socket flap lands somewhere in the middle third.
        acts.append({
            "kind": "kubelet_flap",
            "t": round(rng.uniform(
                duration_s / 3.0, 2.0 * duration_s / 3.0
            ), 6),
            "node": rng.randrange(nodes),
        })
        # Intensity scales extra brownout-kind failpoints.
        for _ in range(max(0, round(intensity) - 1)):
            t, d = window(0.2, 0.4)
            acts.append({
                "kind": "failpoint", "t": t, "duration_s": d,
                "point": "sitter.relist",
                "spec": f"prob:{round(rng.uniform(0.05, 0.15), 4)}"
                        f":{rng.randrange(1 << 30)}",
            })
        prog = cls(seed, acts, {})
        if prog.overlaps() == 0 and len(acts) >= 2:
            # pull the second window into the first: overlap guaranteed
            first = acts[0]
            acts[1]["t"] = round(
                first["t"] + first.get("duration_s", 0.0) / 2.0, 6
            )
        acts.sort(key=lambda a: (a["t"], a["kind"]))
        prog.meta = {
            "chaos_seed": seed,
            "duration_s": duration_s,
            "nodes": nodes,
            "intensity": intensity,
            "actions": len(acts),
            "overlapping_pairs": prog.overlaps(),
            "kinds": sorted({a["kind"] for a in acts}),
        }
        return prog


class OpCursor:
    """Time-ordered consumption of a program's start/stop ops; like
    traffic.TraceCursor, it never reads a clock — the driver (or a
    ManualClock test) supplies ``now``."""

    def __init__(self, ops: List[dict]) -> None:
        self._ops = ops
        self._i = 0

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._ops)

    def due(self, now: float) -> Iterator[dict]:
        while self._i < len(self._ops) and self._ops[self._i]["t"] <= now:
            op = self._ops[self._i]
            self._i += 1
            yield op

    def drain(self) -> Iterator[dict]:
        return self.due(float("inf"))


class ScenarioRunner:
    """Replay one (trace, program) pair against a running FleetSim and
    score it.

    The runner is the only layer with side effects: it routes trace
    requests into per-node RequestObservatories (attached to each
    node's real metrics endpoint, so ``fleet_slo`` scrapes them the
    production way), admits/binds train-tenant pods through the real
    apiserver + kubelet-shaped bind path, applies chaos ops as they
    come due, migrates open streams off draining nodes via the real
    handoff/adopt stitching, then HEALS (disarm, clear, retry, reclaim)
    and scores. ``sabotage`` deliberately breaks stream accounting
    ("drop-streams": every finish becomes a client-visible drop) so the
    known-bad self-test can prove the checker trips.
    """

    def __init__(
        self,
        fleet,
        trace: Trace,
        program: ChaosProgram,
        name: str = "scenario",
        serve_pods_per_node: int = 2,
        sabotage: Optional[str] = None,
        tick_s: float = 0.01,
        settle_timeout_s: float = 60.0,
        clock: Clock = SYSTEM_CLOCK,
    ) -> None:
        self.fleet = fleet
        self.trace = trace
        self.program = program
        self.name = name
        self.serve_pods_per_node = serve_pods_per_node
        self.sabotage = sabotage
        self.tick_s = tick_s
        self.settle_timeout_s = settle_timeout_s
        self.clock = clock
        # runtime state
        self.obs: Dict[int, object] = {}      # node idx -> observatory
        self.open: Dict[int, dict] = {}       # rid -> stream state
        self.unavailable: set = set()         # draining/preempted nodes
        self.seen_chains: Dict[int, set] = {}
        self.train_refs: Dict[str, object] = {}
        self.train_deleted: set = set()
        self.pending_binds: List[object] = []
        self.bind_errors: List[str] = []
        self.admitted = 0
        self.emitted_tokens = 0
        self.routed_rr = 0
        self.throttle_nodes: Dict[int, dict] = {}
        self.execution_log: List[dict] = []
        self.throttle_errors: List[str] = []

    # -- routing -----------------------------------------------------------

    def _healthy_idxs(self) -> List[int]:
        return [
            i for i, node in enumerate(self.fleet.nodes)
            if not node.dead and i not in self.unavailable
        ]

    def _route(self) -> int:
        healthy = self._healthy_idxs()
        if not healthy:  # every node faulted: degrade, don't drop
            healthy = [
                i for i, n in enumerate(self.fleet.nodes) if not n.dead
            ]
        self.routed_rr += 1
        return healthy[self.routed_rr % len(healthy)]

    # -- trace-event side --------------------------------------------------

    def _dispatch_request(self, ev: dict, now: float) -> None:
        idx = self._route()
        obs = self.obs[idx]
        uid = obs.admit(self.fleet.nodes[idx].name, slo=ev["slo"])
        obs.prefill_start(uid)
        seen = self.seen_chains.setdefault(idx, set())
        per_block = max(1, ev["prompt_tokens"] // _TOKENS_PER_BLOCK_DIV)
        hits = 0
        for d in ev["chain"]:
            if d in seen:
                hits += 1
            else:
                break  # prefix cache: a miss ends the cached run
        seen.update(ev["chain"])
        cached = min(hits * per_block, ev["prompt_tokens"])
        obs.prefill_done(
            uid,
            cached_tokens=cached,
            computed_tokens=ev["prompt_tokens"] - cached,
            prefix_digest=ev["chain"][-1],
            chain_digests=tuple(ev["chain"]),
        )
        obs.first_token(uid)
        self.admitted += 1
        self.emitted_tokens += 1  # first_token counts one
        self.open[ev["rid"]] = {
            "uid": uid,
            "node": idx,
            "tokens_left": max(0, ev["output_tokens"] - 1),
            "finish_t": now + _SERVICE_FLOOR_S
            + ev["output_tokens"] * _PER_TOKEN_S,
        }

    def _dispatch_pod(self, ev: dict) -> None:
        name = ev["pod"]
        if ev["kind"] == "pod_admit":
            idx = self._route()
            ref = self.fleet.admit_pod("train", name, idx)
            self.train_refs[name] = ref
            self.pending_binds.append(ref)
        else:  # pod_delete
            ref = self.train_refs.get(name)
            if ref is None or name in self.train_deleted:
                return
            self.pending_binds = [
                r for r in self.pending_binds if r is not ref
            ]
            self.fleet.delete_pods([ref])
            self.train_deleted.add(name)

    def _try_pending_binds(self) -> None:
        """Opportunistic binds: under a brownout or flush fault a bind
        may legitimately fail (FaultError/GroupCommitError surface as
        the kubelet seeing an Allocate error) — it stays queued and is
        retried; recovery drains the queue after the faults heal."""
        still: List[object] = []
        for ref in self.pending_binds:
            if self.fleet.nodes[ref.node_idx].dead:
                still.append(ref)
                continue
            try:
                self.fleet.bind_pod(ref)
            except Exception as e:  # noqa: BLE001 - chaos-era failure
                self.bind_errors.append(
                    f"{ref.pod_key}: {type(e).__name__}"
                )
                still.append(ref)
        self.pending_binds = still

    def _finish_due(self, now: float) -> None:
        done = [
            rid for rid, st in self.open.items()
            if st["finish_t"] <= now
        ]
        for rid in done:
            st = self.open.pop(rid)
            obs = self.obs[st["node"]]
            if st["tokens_left"]:
                obs.tokens_emitted(st["uid"], st["tokens_left"])
                self.emitted_tokens += st["tokens_left"]
            reason = (
                "dropped" if self.sabotage == "drop-streams"
                else "released"
            )
            obs.finish(st["uid"], reason)

    # -- chaos-op side -----------------------------------------------------

    def _migrate_streams_off(self, idx: int) -> None:
        """The drain story's client half: every open stream on the
        draining node hands off (real handoff_begin/adopt stitching)
        to a healthy node and keeps decoding there — TTFT/conservation
        accounting continues on the SAME record."""
        src = self.obs[idx]
        healthy = [i for i in self._healthy_idxs() if i != idx]
        if not healthy:
            return  # nowhere to go; streams finish in place
        for st in self.open.values():
            if st["node"] != idx:
                continue
            rec = src.handoff_begin(st["uid"])
            if rec is None:
                continue
            dst_idx = healthy[self.routed_rr % len(healthy)]
            self.routed_rr += 1
            dst = self.obs[dst_idx]
            st["uid"] = dst.adopt(rec, self.fleet.nodes[dst_idx].name)
            st["node"] = dst_idx

    def _throttle_drive(self, idx: int, hog_duty: float) -> None:
        from ..workloads.telemetry import write_usage_report

        state = self.throttle_nodes.get(idx)
        if state is None:
            return
        node = self.fleet.nodes[idx]
        now = time.time()
        write_usage_report(
            node.opts.alloc_spec_dir, state["calm_hash"], 2.0, ts=now
        )
        write_usage_report(
            node.opts.alloc_spec_dir, state["hog_hash"], hog_duty, ts=now
        )
        # The controller journals its ledger in the node's store, so a
        # flush fault of the program can fail this pass, as it fails a
        # supervised tick in the agent: the failure is counted and the
        # next tick drives again (the agent's sim lets it end the run).
        try:
            node.manager.sampler.sample_once(now=now)
            node.manager.repartition.tick(now=now)
        except Exception as e:  # noqa: BLE001 - chaos-era failure
            self.throttle_errors.append(f"node-{idx}: {type(e).__name__}")

    def _throttle_start(self, idx: int) -> None:
        from ..device.qos import AnnotationRepartition

        ann = {AnnotationRepartition: "true"}
        # The pair shares the node's third card, as the agent's sim puts
        # it (card 2); a node of fewer cards gives them its last one.
        chips = self.fleet.chip_indexes(self.fleet.nodes[idx])
        chip = chips[min(2, len(chips) - 1)]
        calm = self.fleet.admit_pod(
            "qos", f"calm-{idx}", idx, chip=chip, annotations=ann
        )
        hog = self.fleet.admit_pod(
            "qos", f"hog-{idx}", idx, chip=chip, annotations=ann
        )
        self.fleet.wait_synced([calm, hog])
        # The throttle window opens DURING other fault windows (that is
        # the matrix's whole point), so these binds can hit an injected
        # flush failure exactly like the train-tenant binds — retry
        # through it rather than letting one unlucky draw kill the
        # scenario. Persistent failure surfaces as a violation: the
        # refs go to pending_binds and recovery's never-landed check.
        for ref in (calm, hog):
            deadline = time.monotonic() + 5.0
            while True:
                try:
                    self.fleet.bind_pod(ref)
                    break
                except Exception as e:  # noqa: BLE001 - chaos-era
                    self.bind_errors.append(
                        f"{ref.pod_key}: {type(e).__name__}"
                    )
                    if time.monotonic() > deadline:
                        self.pending_binds.append(ref)
                        return  # no throttle state: binds never landed
                    time.sleep(0.05)
        self.throttle_nodes[idx] = {
            "calm_hash": self.fleet.alloc_hash_of(calm),
            "hog_hash": self.fleet.alloc_hash_of(hog),
            "refs": [calm, hog],
            "active": True,
            "was_throttled": False,
        }

    def _apply_op(self, op: dict, now: float) -> None:
        a = op["action"]
        kind, phase = a["kind"], op["op"]
        self.execution_log.append({
            "t": round(now, 4), "op": phase, "kind": kind,
        })
        registry = faults.get_registry()
        if kind == "apiserver_brownout":
            if phase == "start":
                self.fleet.apiserver.set_brownout(
                    error_rate=a["error_rate"],
                    latency_s=a.get("latency_s", 0.0),
                    seed=a["seed"],
                )
            else:
                self.fleet.apiserver.clear_brownout()
        elif kind == "failpoint":
            if phase == "start":
                registry.arm(a["point"], a["spec"])
            else:
                registry.disarm(a["point"])
        elif kind == "maintenance_drain":
            if phase == "start":
                self.unavailable.add(a["node"])
                self._migrate_streams_off(a["node"])
                self.fleet.trigger_maintenance(a["node"])
            else:
                self.fleet.clear_maintenance(a["node"])
                # routing stays off the node until scenario end: the
                # drain orchestrator un-cordons on its own schedule
        elif kind == "preemption":
            self.unavailable.add(a["node"])
            self._migrate_streams_off(a["node"])
            self.fleet.trigger_preemption(a["node"])
        elif kind == "kubelet_flap":
            self.fleet.nodes[a["node"]].kubelet.restart_registration()
        elif kind == "throttle":
            if phase == "start":
                self._throttle_start(a["node"])
            else:
                state = self.throttle_nodes.get(a["node"])
                if state:
                    state["active"] = False

    # -- main loop ---------------------------------------------------------

    def run(self) -> dict:
        from ..workloads.request_obs import RequestObservatory

        wall_t0 = time.perf_counter()
        for i, node in enumerate(self.fleet.nodes):
            if node.dead:
                continue
            obs = RequestObservatory(max_finished=65536)
            node.metrics.attach_requests(obs)
            self.obs[i] = obs

        # Serve-tenant homes, bound through the real paths BEFORE any
        # fault window opens.
        serve_refs = self.fleet.admit_pods(
            self.serve_pods_per_node, namespace="serve"
        )
        self.fleet.wait_synced(serve_refs)
        for ref in serve_refs:
            self.fleet.bind_pod(ref)

        tcur = TraceCursor(self.trace)
        ocur = OpCursor(self.program.ops())
        horizon = max(
            self.trace.meta["duration_s"], self.program.end_t()
        )
        t0 = self.clock.monotonic()
        deadline = t0 + self.settle_timeout_s
        while True:
            now = self.clock.monotonic() - t0
            for op in ocur.due(now):
                self._apply_op(op, now)
            for ev in tcur.due(now):
                if ev["kind"] == "request":
                    self._dispatch_request(ev, now)
                elif ev["kind"].startswith("pod_"):
                    self._dispatch_pod(ev)
            self._try_pending_binds()
            self._finish_due(now)
            for idx, state in self.throttle_nodes.items():
                if state["active"]:
                    self._throttle_drive(idx, 90.0)
                    if "qos/hog-%d" % idx in self.fleet.nodes[
                        idx
                    ].manager.repartition.status()["throttled_pods"]:
                        state["was_throttled"] = True
            if (
                now >= horizon
                and not self.open
                and tcur.exhausted
                and ocur.exhausted
            ):
                break
            if self.clock.monotonic() > deadline:
                break  # scored anyway; leftovers become violations
            time.sleep(self.tick_s)

        recovery = self._recover()
        report = self._score(serve_refs)
        report["recovery"] = recovery
        report["wall_s"] = round(time.perf_counter() - wall_t0, 3)
        return report

    # -- recovery ----------------------------------------------------------

    def _recover(self) -> dict:
        """Heal the world, then let in-flight work converge: faults
        disarmed, brownout cleared, drains cancelled, queued binds
        retried, hogs unthrottled, train tenants reclaimed. A scenario
        that cannot recover to a clean fleet IS a finding — leftovers
        surface through the compound invariants."""
        out: Dict[str, object] = {}
        for op in self.program.ops():
            if op["op"] == "stop":
                # stops that never came due (scenario ended inside a
                # window) must still apply so arm/brownout state cannot
                # leak; re-applying an executed stop is a no-op (disarm
                # of an unarmed point, clearing a cleared brownout).
                self._apply_op(op, -1.0)
        faults.get_registry().disarm()
        self.fleet.apiserver.clear_brownout()
        for idx in list(self.unavailable):
            try:
                self.fleet.clear_maintenance(idx)
            except Exception:  # noqa: BLE001 - preempted nodes keep it
                pass
        self._finish_due(float("inf"))
        deadline = time.monotonic() + self.settle_timeout_s / 2.0
        attempts = 0
        while self.pending_binds and time.monotonic() < deadline:
            attempts += 1
            self._try_pending_binds()
            if self.pending_binds:
                time.sleep(0.05)
        out["bind_retry_rounds"] = attempts
        out["binds_never_landed"] = [
            r.pod_key for r in self.pending_binds
        ]
        # unthrottle any still-clamped hog (drive good behavior)
        for idx, state in self.throttle_nodes.items():
            t_end = time.monotonic() + 10.0
            while (
                "qos/hog-%d" % idx in self.fleet.nodes[idx].manager
                .repartition.status()["throttled_pods"]
            ):
                if time.monotonic() > t_end:
                    out.setdefault("problems", []).append(
                        f"hog-{idx} never unthrottled"
                    )
                    break
                self._throttle_drive(idx, 5.0)
                time.sleep(0.05)
        # train tenants: delete whatever the trace left admitted, then
        # require every deleted pod's bind to be reclaimed (GC through
        # the healed apiserver) — a replay afterwards is a violation.
        leftover = [
            ref for name, ref in self.train_refs.items()
            if name not in self.train_deleted
        ]
        if leftover:
            self.fleet.delete_pods(leftover)
        reclaim_refs = [
            ref for ref in self.train_refs.values()
            if not self.fleet.nodes[ref.node_idx].dead
        ]
        try:
            out["reclaim_wait_s"] = round(self.fleet.wait_reclaimed(
                reclaim_refs, timeout_s=self.settle_timeout_s / 2.0
            ), 3)
        except RuntimeError as e:
            out["reclaim_error"] = str(e)
        # replay check: one reconcile period later the records must
        # still be gone (a reconciler replaying a reclaimed bind is
        # exactly the class of bug the matrix exists to catch)
        time.sleep(min(1.0, 2.0 * self.fleet.reconcile_period_s))
        replays = [
            ref.pod_key for ref in reclaim_refs
            if self.fleet.nodes[ref.node_idx].storage.load(
                ref.namespace, ref.name
            ) is not None
        ]
        out["reclaimed_bind_replays"] = replays
        self.fleet.tick_goodput()
        return out

    # -- scoring -----------------------------------------------------------

    def _records_of(self, ref) -> int:
        node = self.fleet.nodes[ref.node_idx]
        if node.dead:
            return -1  # unknowable; not a double-land
        info = node.storage.load(ref.namespace, ref.name)
        if info is None:
            return 0
        return sum(1 for _ in info.records())

    def _score(self, serve_refs) -> dict:
        from .aggregator import FleetAggregator

        agg = FleetAggregator(self.fleet.targets())
        goodput = agg.fleet_goodput()
        slo = agg.fleet_slo()

        finished = live = pending = 0
        reasons: Dict[str, int] = {}
        published = adopted = 0
        worst_residual = 0.0
        accounted_tokens = 0
        for obs in self.obs.values():
            finished += obs.finished_total
            live += obs.live_count
            pending += obs.pending_handoff_count
            published += obs.handoffs_published
            adopted += obs.handoffs_adopted
            for reason, n in obs.finish_reasons.items():
                reasons[reason] = reasons.get(reason, 0) + n
            worst = obs._worst_residual_s
            if abs(worst) > abs(worst_residual):
                worst_residual = worst
            accounted_tokens += sum(
                rec.tokens for rec in obs._finished
            )
        drops = sum(
            n for r, n in reasons.items()
            if r in CLIENT_VISIBLE_DROP_REASONS
        )
        expired = reasons.get("handoff_expired", 0)

        double_lands = missing = 0
        for ref in serve_refs:
            n = self._records_of(ref)
            if n > 1:
                double_lands += 1
            elif n == 0 and ref.node_idx not in self.unavailable:
                missing += 1
        open_intents = sum(
            len(node.storage.open_intents())
            for node in self.fleet.nodes if not node.dead
        )
        throttles = {
            f"node-{idx}": state["was_throttled"]
            for idx, state in self.throttle_nodes.items()
        }
        return {
            "scenario": self.name,
            "trace": {**self.trace.meta, "digest": self.trace.digest()},
            "program": {
                **self.program.meta, "digest": self.program.digest(),
            },
            "repro": repro_line(
                self.trace.seed, self.program.seed, self.name
            ),
            "goodput": {
                **goodput["fleet"],
                "conservation_problems": goodput[
                    "conservation_problems"
                ],
                "unreachable_nodes": goodput["unreachable"],
            },
            "slo": slo["fleet"]["classes"],
            "compound": {
                "streams": {
                    "admitted": self.admitted,
                    "finished": finished,
                    "live_leftover": live,
                    "pending_handoff_leftover": pending,
                    "client_visible_drops": drops,
                    "finish_reasons": reasons,
                },
                "handoffs": {
                    "published": published,
                    "adopted": adopted,
                    "expired": expired,
                },
                "worst_residual_s": round(worst_residual, 6),
                "tokens": {
                    "emitted": self.emitted_tokens,
                    "accounted": accounted_tokens,
                },
                "binds": {
                    "serve_pods": len(serve_refs),
                    "double_lands": double_lands,
                    "records_missing": missing,
                    "bind_errors_during_faults": len(self.bind_errors),
                },
                "open_intents": open_intents,
                "throttled": throttles,
                "throttle_errors_during_faults": len(self.throttle_errors),
            },
        }


class ChaosMatrix:
    """A bounded, seeded set of compound scenarios; every verdict
    reproducible from ``(trace_seed, chaos_seed)``."""

    def __init__(
        self,
        trace_seed: int = 1,
        chaos_seed: int = 1,
        scenarios: Optional[List[dict]] = None,
        nodes: int = 2,
        serve_pods_per_node: int = 2,
        enable_events: bool = True,
    ) -> None:
        self.trace_seed = trace_seed
        self.chaos_seed = chaos_seed
        self.nodes = nodes
        self.serve_pods_per_node = serve_pods_per_node
        # Poll-only mode (events.py disabled): the matrix must stay
        # green either way — the periodic sweeps remain the correctness
        # backstop, events are only an acceleration.
        self.enable_events = enable_events
        self.scenarios = scenarios or self.default_scenarios()

    def default_scenarios(self) -> List[dict]:
        return [
            {
                "name": "brownout-flash-crowd",
                "trace": {
                    "duration_s": 2.5, "base_rps": 24.0,
                    "flash_crowds": 1, "hostile_fraction": 0.3,
                    "train_pods": 2,
                },
                "program": {
                    "duration_s": 2.5, "include_drain": False,
                },
            },
            {
                "name": "drain-under-hostile-prefix",
                "trace": {
                    "duration_s": 3.0, "base_rps": 16.0,
                    "flash_crowds": 1, "hostile_fraction": 0.9,
                    "train_pods": 2,
                },
                "program": {
                    "duration_s": 3.0, "include_drain": True,
                },
            },
            {
                # A spot-preemption notice rings on the node ALREADY
                # mid-migration (draining, streams handing off) while a
                # flash crowd runs — the live-migration acceptance
                # scenario: zero client-visible drops/resets, every
                # handoff adopted, and goodput/SLO floors hold.
                "name": "preemption-during-migration",
                "trace": {
                    "duration_s": 3.0, "base_rps": 20.0,
                    "flash_crowds": 1, "hostile_fraction": 0.3,
                    "train_pods": 2,
                },
                "program": {
                    "duration_s": 3.0, "include_drain": True,
                    "include_preemption": True,
                },
                "bounds": {
                    "min_goodput_percent": 25.0,
                    "min_slo_attainment": 0.5,
                },
            },
        ]

    def _seeds_for(self, i: int, spec: Optional[dict] = None):
        """Per-scenario sub-seeds. A spec carrying an explicit
        ``index`` (a filtered run, e.g. the repro's --scenario) keeps the
        seeds it had at its position in the full matrix — the repro
        line must rebuild the exact same trace and program."""
        idx = spec.get("index", i) if spec else i
        return self.trace_seed + 1000 * idx, self.chaos_seed + 1000 * idx

    def schedules(self) -> List[dict]:
        """Generate (but do not execute) every scenario's trace+program
        — the cheap half a determinism check runs twice."""
        out = []
        for i, spec in enumerate(self.scenarios):
            ts, cs = self._seeds_for(i, spec)
            trace = TraceGenerator(seed=ts, **spec["trace"]).generate()
            program = ChaosProgram.generate(
                seed=cs, nodes=self.nodes, **spec["program"]
            )
            out.append({
                "scenario": spec["name"],
                "trace_digest": trace.digest(),
                "program_digest": program.digest(),
                "trace_events": len(trace.events),
                "program_actions": len(program.actions),
                "overlapping_pairs": program.meta["overlapping_pairs"],
            })
        return out

    def schedule_digest(self) -> str:
        h = hashlib.sha256()
        for s in self.schedules():
            h.update(s["trace_digest"].encode())
            h.update(s["program_digest"].encode())
        return h.hexdigest()[:16]

    def _run_one(
        self, i: int, spec: dict, base_dir: str,
        sabotage: Optional[str] = None,
    ) -> dict:
        import os

        from .fleet import FleetSim
        from .scale import scale_problems

        ts, cs = self._seeds_for(i, spec)
        trace = TraceGenerator(seed=ts, **spec["trace"]).generate()
        program = ChaosProgram.generate(
            seed=cs, nodes=self.nodes, **spec["program"]
        )
        sim = FleetSim(
            os.path.join(base_dir, f"s{i}"),
            nodes=self.nodes,
            reconcile_period_s=0.5,
            slice_membership_ttl_s=0.25,
            drain_deadline_s=30.0,  # scenarios end before the deadline
            drain_period_s=0.25,
            migration_period_s=0.1,
            goodput_period_s=3600.0,  # ticked explicitly
            enable_sampler=True,
            sampler_period_s=3600.0,  # throttle drives by hand
            repartition_period_s=3600.0,
            storage_batch_window_s=0.004,  # flush faults need batching
            sink_flush_window_s=0.02,
            enable_events=self.enable_events,
        )
        os.makedirs(os.path.join(base_dir, f"s{i}"), exist_ok=True)
        try:
            sim.start()
            runner = ScenarioRunner(
                sim, trace, program,
                name=spec["name"],
                serve_pods_per_node=self.serve_pods_per_node,
                sabotage=sabotage,
            )
            report = runner.run()
        finally:
            faults.get_registry().disarm()
            sim.stop()
        report["problems"] = scale_problems(
            report, spec.get("bounds")
        )
        return report

    def run(self, base_dir: str) -> dict:
        """Execute every scenario; the matrix verdict is the union of
        per-scenario problems (empty = the ugly day was served)."""
        results = []
        problems: List[str] = []
        for i, spec in enumerate(self.scenarios):
            report = self._run_one(i, spec, base_dir)
            results.append(report)
            for p in report["problems"]:
                problems.append(f"{spec['name']}: {p}")
        return {
            "trace_seed": self.trace_seed,
            "chaos_seed": self.chaos_seed,
            "schedule_digest": self.schedule_digest(),
            "scenarios": results,
            "problems": problems,
        }

    def self_test(self, base_dir: str) -> dict:
        """Known-bad run: sabotaged stream accounting must trip the
        checker — a matrix whose checker cannot fail is not a check."""
        spec = self.scenarios[0]
        report = self._run_one(
            0, spec, base_dir, sabotage="drop-streams"
        )
        return {
            "tripped": bool(report["problems"]),
            "problems": report["problems"][:5],
            "repro": report["repro"],
        }
