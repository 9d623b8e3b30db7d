"""Black-box lifecycle timeline: a durable, causally-ordered event journal.

The port's copy of ``elastic_tpu_agent/timeline.py``. Every state
transition the port's agent makes calls :meth:`Timeline.emit` with the
join keys it already has in hand:

- bind transaction phases: ``bind_intent`` / ``bind_commit`` /
  ``bind_rollback`` / ``bind_replay`` (plugins/gpushare.py);
- every reconciler repair, one ``reconcile_repair`` event a repair with
  the divergence class as an attribute (reconciler.py);
- health and cordon flips (``chip_health`` / ``cordon``), GC reclaims
  (``pod_reclaimed``);
- supervisor restarts and circuit-breaker trips (``subsystem_restart`` /
  ``subsystem_crash_loop``), one ``agent_started`` a boot (version and
  boot id), and ``slow_span`` from the tracer's slow-span listener.

The kinds of the agent's subsystems that the port has not yet (drain,
slices, repartition, migration) stay in the vocabulary: the journal lives
in the node's checkpoint db, which either agent opens, and either agent's
``Timeline`` reads the other's rows.

Events land in a ring-capped Storage table (``timeline``): restart
durable (the checkpoint store's SQLite file), monotonic per-agent seq
numbers that survive the ring trim and restarts, and a durable eviction
counter so that bounded growth is itself observable. Reads need no live
agent: ``node-doctor timeline`` reconstructs a history from a dead
agent's db.

The journal is observability, never load-bearing: :meth:`Timeline.emit`
swallows every failure (a full disk must not fail a bind), and every call
site treats the timeline as optional.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Iterable, List, Optional

from .common import SYSTEM_CLOCK

logger = logging.getLogger(__name__)

# Ring cap: bounds the table under pod churn. ~4k events keeps weeks of
# steady-state lifecycle on a quiet node and the full story of a busy
# incident; at ~300 bytes/row the table stays under ~1.5 MB.
DEFAULT_CAP = 4096

# -- event kinds --------------------------------------------------------------

KIND_AGENT_STARTED = "agent_started"
# bind transaction phases (plugins/gpushare.py)
KIND_BIND_INTENT = "bind_intent"
KIND_BIND_COMMIT = "bind_commit"
KIND_BIND_ROLLBACK = "bind_rollback"
KIND_BIND_REPLAY = "bind_replay"
# one per reconciler repair; the divergence class rides in attrs["class"]
KIND_RECONCILE_REPAIR = "reconcile_repair"
# drain lifecycle (drain.py): attrs carry state/trigger/deadline
KIND_DRAIN_TRANSITION = "drain_transition"
# slice orchestration (slices/): epoch in attrs
KIND_SLICE_FORMED = "slice_formed"
KIND_SLICE_REFORMED = "slice_reformed"
# health & schedulability
KIND_CHIP_HEALTH = "chip_health"
KIND_CORDON = "cordon"
# GC reclaim of a deleted pod's bindings (the reconciler's reclaims are
# reconcile_repair events with class=reclaimed_pod)
KIND_POD_RECLAIMED = "pod_reclaimed"
# dynamic fractional re-partitioning (repartition.py): one event per
# executed quota move (attrs: direction grow|shrink, donor, borrower,
# core_units, hbm_bytes) keyed by pod + chip, so a grant's growth/shrink
# history reconstructs causally next to its binds and drains
KIND_REPARTITION = "repartition"
# sustained-overcommit escalation (repartition.py): attrs.action is
# throttle | unthrottle | evict, with the evict deadline where relevant
KIND_THROTTLE = "throttle"
# migration handshake (migration.py): attrs.action walks the record's
# life — recorded | record_published | early_reclaim (source side),
# restore_stamped | completed | verify_failed (destination side) — all
# keyed pod + the SOURCE bind's trace id, so one id links the drain,
# the checkpoint ack and the verified resume across nodes
KIND_MIGRATION = "migration"
# supervision (supervisor.py)
KIND_SUBSYSTEM_RESTART = "subsystem_restart"
KIND_SUBSYSTEM_CRASH_LOOP = "subsystem_crash_loop"
# latency outliers (tracing.py slow-span listener via manager.py):
# keyed pod + trace so a stall lands in the causal journal next to the
# bind or drain it delayed
KIND_SLOW_SPAN = "slow_span"


class Timeline:
    """The agent's append-only lifecycle journal (one per agent/node).

    Join keys are a small, fixed vocabulary — ``pod`` ("ns/name"),
    ``container``, ``slice``, ``chips`` (list of ints), ``hash``,
    ``trace``, ``node`` — the ids the rest of the system already
    stamps everywhere, so per-entity histories are reconstructable by
    key equality alone. ``node`` is auto-filled from the agent's
    identity and ``trace`` from the thread's active trace (tracing.py),
    so call sites only name what the generic plumbing cannot know.
    """

    def __init__(
        self,
        storage,
        node_name: str = "",
        metrics=None,
        cap: int = DEFAULT_CAP,
        clock=None,
    ) -> None:
        self._storage = storage
        self._node = node_name
        self._metrics = metrics
        self.cap = max(1, cap)
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        # One boot id per Timeline (== per manager instance): stamped on
        # agent_started and into the doctor bundle, so two histories
        # from the same node are attributable to the right process.
        self.boot_id = os.urandom(4).hex()
        self._lock = threading.Lock()
        self.emitted_total = 0
        self.dropped_total = 0  # emits the journal write lost

    # -- writing --------------------------------------------------------------

    def emit(
        self, kind: str, keys: Optional[dict] = None, **attrs
    ) -> Optional[int]:
        """Journal one lifecycle event; returns its seq, or None when
        the write failed (never raises — the journal is observability).
        """
        try:
            event_keys: Dict[str, object] = dict(keys or {})
            event_keys.setdefault("node", self._node)
            if "trace" not in event_keys:
                from .tracing import get_tracer

                trace_id = get_tracer().current_id()
                if trace_id:
                    event_keys["trace"] = trace_id
            seq = self._storage.timeline_append(
                self._clock.time(), kind, event_keys, attrs, self.cap
            )
            if kind == KIND_AGENT_STARTED:
                # Boot identity also lands in the never-evicted meta
                # table: the doctor bundle must answer "did it restart
                # mid-incident" even after churn has trimmed the
                # agent_started ROW out of the ring.
                self._storage.timeline_set_meta(
                    "timeline_boot_id", str(attrs.get("boot_id", ""))
                )
                self._storage.timeline_set_meta(
                    "timeline_agent_version",
                    str(attrs.get("version", "")),
                )
            with self._lock:
                self.emitted_total += 1
            m = self._metrics
            if m is not None and hasattr(m, "timeline_events"):
                try:
                    m.timeline_events.inc()
                except Exception:  # noqa: BLE001
                    pass
            return seq
        except Exception as e:  # noqa: BLE001 - never load-bearing
            with self._lock:
                self.dropped_total += 1
            logger.warning("timeline emit %s dropped: %s", kind, e)
            return None

    # -- reading --------------------------------------------------------------

    def events(
        self,
        pod: Optional[str] = None,
        slice_id: Optional[str] = None,
        chip: Optional[int] = None,
        node: Optional[str] = None,
        trace: Optional[str] = None,
        kinds: Optional[Iterable[str]] = None,
        since: Optional[float] = None,
        limit: Optional[int] = None,
        causal: bool = True,
    ) -> List[dict]:
        """The journal filtered to one entity's history, seq-ordered.
        With ``causal=True`` (the default) the direct matches are
        expanded along their join keys — see :func:`select_events`."""
        rows = self._storage.timeline_rows(since_ts=since)
        return select_events(
            rows, pod=pod, slice_id=slice_id, chip=chip, node=node,
            trace=trace, kinds=kinds, limit=limit, causal=causal,
        )

    def status(self) -> dict:
        """The ``timeline`` block shared by /debug/timeline, the doctor
        bundle and tests: durable counters + this boot's identity."""
        try:
            count = self._storage.timeline_count()
            evicted = self._storage.timeline_evicted_total()
        except Exception:  # noqa: BLE001 - storage may be closed
            count, evicted = None, None
        with self._lock:
            return {
                "cap": self.cap,
                "total_events": count,
                "evicted_total": evicted,
                "emitted_this_boot": self.emitted_total,
                "dropped_this_boot": self.dropped_total,
                "boot_id": self.boot_id,
                "node": self._node,
            }


# -- pure selection / reconstruction helpers ----------------------------------
#
# Module-level so that a merged multi-node event list is filtered with the
# SAME entity semantics that Timeline.events applies to one node's
# journal.


def _direct_match(
    event: dict,
    pod: Optional[str],
    slice_id: Optional[str],
    chip: Optional[int],
    node: Optional[str],
    trace: Optional[str],
) -> bool:
    keys = event.get("keys", {})
    if pod is not None:
        cand = str(keys.get("pod", ""))
        if cand != pod and cand.rpartition("/")[2] != pod:
            return False
    if slice_id is not None and keys.get("slice") != slice_id:
        return False
    if chip is not None and chip not in (keys.get("chips") or []):
        return False
    if node is not None and keys.get("node") != node:
        return False
    if trace is not None and keys.get("trace") != trace:
        return False
    return True


# Node-scoped lifecycle context: events with no pod/slice/trace of
# their own that are nonetheless part of every co-located entity's
# story — a pod's history that omits "the agent restarted" or "the
# node started draining" explains its reclaim with a gap where the
# cause goes.
CONTEXT_KINDS = frozenset({
    KIND_AGENT_STARTED,
    KIND_DRAIN_TRANSITION,
    KIND_CORDON,
    KIND_SUBSYSTEM_CRASH_LOOP,
})


def select_events(
    rows: List[dict],
    pod: Optional[str] = None,
    slice_id: Optional[str] = None,
    chip: Optional[int] = None,
    node: Optional[str] = None,
    trace: Optional[str] = None,
    kinds: Optional[Iterable[str]] = None,
    limit: Optional[int] = None,
    causal: bool = True,
) -> List[dict]:
    """Filter a seq-ordered event list down to one entity's history.

    Two passes. First, **direct** matches by join-key equality (pod
    accepts bare names like the trace dump does). Second, when
    ``causal=True`` and an entity filter was given, the history is
    expanded along causal links, each expansion flagged
    ``"related": True``:

    - events sharing a *trace id* or a *slice id* with a direct match
      — so a pod's history includes the reform that restamped it
      (emitted under its slice, possibly on another node) and the
      reconciler repair that rolled its crashed bind back (emitted
      under the reconcile pass's trace);
    - node-scoped lifecycle context (:data:`CONTEXT_KINDS` — agent
      boots, drain transitions, cordons, breaker trips) on any node a
      direct match lives on, plus ``chip_health`` flips touching the
      entity's chips — the "why" behind a reclaim is usually one of
      these.

    With no entity filter the journal is returned as-is (kind/limit
    still applied)."""
    entity_filtered = any(
        v is not None for v in (pod, slice_id, chip, node, trace)
    )
    if not entity_filtered:
        selected = list(rows)
    else:
        direct = [
            e for e in rows
            if _direct_match(e, pod, slice_id, chip, node, trace)
        ]
        if causal:
            traces = {
                e["keys"].get("trace") for e in direct
                if e["keys"].get("trace")
            }
            slices = {
                e["keys"].get("slice") for e in direct
                if e["keys"].get("slice")
            }
            nodes = {
                e["keys"].get("node") for e in direct
                if e["keys"].get("node")
            }
            chips: set = set()
            for e in direct:
                chips.update(e["keys"].get("chips") or [])
            direct_seqs = {
                (e["keys"].get("node"), e["seq"]) for e in direct
            }
            selected = []
            for e in rows:
                key = (e["keys"].get("node"), e["seq"])
                if key in direct_seqs:
                    selected.append(e)
                    continue
                linked = (
                    e["keys"].get("trace") in traces
                    or (slices and e["keys"].get("slice") in slices)
                    or (
                        e["kind"] in CONTEXT_KINDS
                        and e["keys"].get("node") in nodes
                    )
                    or (
                        e["kind"] == KIND_CHIP_HEALTH
                        and chips
                        and chips & set(e["keys"].get("chips") or [])
                    )
                )
                if linked:
                    related = dict(e)
                    related["related"] = True
                    selected.append(related)
        else:
            selected = direct
    if kinds is not None:
        kind_set = set(kinds)
        selected = [e for e in selected if e["kind"] in kind_set]
    if limit is not None and limit >= 0:
        selected = selected[-limit:] if limit else []
    return selected


def merge_node_events(per_node: Dict[str, List[dict]]) -> List[dict]:
    """Interleave per-node journals into one fleet-ordered causal view.

    K-way merge by wall time that NEVER reorders one node's events
    against each other: within a node, seq order is the causal order
    (the emitting thread journaled before the next transition ran), so
    the merge only chooses *between* nodes by ts — adopted trace ids
    then stitch the cross-node story (admission → bind → reform) that
    no single clock could. Ties break by node name for determinism."""
    heads = {
        node: 0 for node, events in per_node.items() if events
    }
    out: List[dict] = []
    while heads:
        best_node = min(
            heads,
            key=lambda n: (per_node[n][heads[n]].get("ts", 0.0), n),
        )
        out.append(per_node[best_node][heads[best_node]])
        heads[best_node] += 1
        if heads[best_node] >= len(per_node[best_node]):
            del heads[best_node]
    return out


def verify_bind_story(events: List[dict]) -> List[str]:
    """Consistency check over a (single- or merged-) journal's bind
    events; returns problems (empty = the story holds). The crash-replay
    suite runs this after every kill-at-a-failpoint replay:

    - **no phantom commits**: every ``bind_commit`` that names an
      intent id must be preceded (per node) by the matching
      ``bind_intent``. Claimed only for nodes whose journal still
      starts at seq 1: once the ring has evicted rows, a missing
      intent event is indistinguishable from an evicted one (eviction
      drops oldest-first, so the commit can outlive its intent — but
      never the other way around, which is why the dangling check
      below stays valid under eviction);
    - **no dangling intents**: every ``bind_intent`` must be resolved —
      a later commit, an explicit ``bind_rollback``, or a reconciler
      ``reconcile_repair`` whose class names the intent's fate
      (``intent_rolled_back`` / ``intent_committed``) — once the system
      has converged (callers run this only after convergence).
    """
    problems: List[str] = []
    open_intents: Dict[tuple, dict] = {}
    min_seq: Dict[str, int] = {}
    for e in events:
        node = e.get("keys", {}).get("node", "")
        seq = e.get("seq")
        if isinstance(seq, int):
            min_seq[node] = min(min_seq.get(node, seq), seq)
    for e in events:
        node = e.get("keys", {}).get("node", "")
        kind = e.get("kind")
        attrs = e.get("attrs", {})
        intent_id = attrs.get("intent_id")
        if kind == KIND_BIND_INTENT and intent_id is not None:
            open_intents[(node, intent_id)] = e
        elif kind == KIND_BIND_COMMIT:
            if intent_id is not None:
                if (
                    (node, intent_id) not in open_intents
                    and min_seq.get(node) == 1
                ):
                    problems.append(
                        f"phantom commit: seq {e.get('seq')} on "
                        f"{node or '?'} commits intent {intent_id} with "
                        "no preceding bind_intent event"
                    )
                open_intents.pop((node, intent_id), None)
        elif kind == KIND_BIND_ROLLBACK and intent_id is not None:
            open_intents.pop((node, intent_id), None)
        elif kind == KIND_RECONCILE_REPAIR and attrs.get("class") in (
            "intent_rolled_back", "intent_committed",
        ):
            if intent_id is not None:
                open_intents.pop((node, intent_id), None)
    for (node, intent_id), e in sorted(
        open_intents.items(), key=lambda kv: kv[1].get("seq", 0)
    ):
        problems.append(
            f"dangling intent: seq {e.get('seq')} on {node or '?'} "
            f"journaled bind_intent {intent_id} for "
            f"{e.get('keys', {}).get('pod')} and no surviving event "
            "resolves it"
        )
    return problems
