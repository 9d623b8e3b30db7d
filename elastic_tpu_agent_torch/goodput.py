"""Goodput ledger: each second of a pod's life, and what it was spent on.

The port's copy of ``elastic_tpu_agent/goodput.py``. The agent causes most
of a workload's non-productive time (drains, QoS throttles and evictions,
migrations, crash replays), and the durable timeline (timeline.py) with
the checkpoint handshake (migration.py) records every transition. This
module rolls those rows up into **goodput**, and seconds of downtime
attributed to a cause.

For every pod the agent bound, wall time partitions gap-free into exactly
one of seven states:

==============  ==============================================================
state           meaning (and the journal evidence that claims it)
==============  ==============================================================
productive      no claim: the pod held its grant and nothing the agent did
                was in the way
queued          bind in flight: ``bind_intent`` .. ``bind_commit``
checkpointing   a drain/throttle/reform signal told the workload to save:
                signal .. the checkpoint ack (``migration`` action=recorded,
                or the ack sidecar's timestamp for reforms)
migrating       work moving between generations: source side from the
                consumed ack to the early reclaim; destination side from
                admission to the verified resume (action=completed)
draining        a drain signal is standing and the resident never acked
throttled       QoS enforcement: ``throttle`` action=throttle .. unthrottle,
                and the evict window up to the reclaim
unattributed    time the ledger cannot explain: agent crash windows (the
                gap a mid-lifetime ``agent_started`` reveals), attributed
                to the boot event when one is visible
==============  ==============================================================

**Conservation**: per pod, the intervals partition the pod's known
lifetime: they sum to it exactly, never overlap, and every non-productive
interval (unattributed excepted) carries a cause id ``(node, seq)`` that
resolves in the timeline. The replay is a pure function of the journal,
so a restarted agent's first tick reproduces the ledger; the lifetime
starts of long-lived pods whose bind rows the ring trimmed are journaled
in ``agent_state`` (key ``goodput``) and resumed.

Surfaced as the bounded ``elastic_tpu_goodput_ratio{pod}`` and
``elastic_tpu_downtime_seconds_total{cause}`` families, the loopback
``/debug/goodput`` endpoint, and a schema-checked ``goodput`` block of the
doctor bundle that reads a dead agent's db (``node-doctor goodput``).
The ``slice_reformed`` cause prices a reform row an agent-written db may
hold. Standard library only.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from .common import SYSTEM_CLOCK
from . import timeline as tl

logger = logging.getLogger(__name__)

DEFAULT_PERIOD_S = 10.0
_STATE_KEY = "goodput"

# -- the seven states ---------------------------------------------------------

PRODUCTIVE = "productive"
CHECKPOINTING = "checkpointing"
MIGRATING = "migrating"
DRAINING = "draining"
THROTTLED = "throttled"
QUEUED = "queued"
UNATTRIBUTED = "unattributed"

STATES = (
    PRODUCTIVE, CHECKPOINTING, MIGRATING, DRAINING, THROTTLED, QUEUED,
    UNATTRIBUTED,
)

# When claims overlap (a drain signal lands on an already-throttled pod,
# an ack arrives mid-drain), the instant belongs to the HIGHEST-priority
# claim — each wall-clock second is counted exactly once. Productive is
# the absence of any claim.
_PRIORITY = {
    QUEUED: 60,        # nothing else can be true before the bind commits
    MIGRATING: 50,     # the handshake is the most specific explanation
    CHECKPOINTING: 40,
    THROTTLED: 30,
    DRAINING: 20,
    UNATTRIBUTED: 10,  # only claims what nothing else explains
}

# -- downtime cause categories (the {cause} label vocabulary) -----------------

CAUSE_MAINTENANCE = "maintenance_drain"
CAUSE_PREEMPTION = "preemption"
CAUSE_OPERATOR_DRAIN = "operator_drain"
CAUSE_QOS_THROTTLE = "qos_throttle"
CAUSE_QOS_EVICT = "qos_evict"
CAUSE_MIGRATION = "migration"
# Pre-copy migrations split the old blanket "migration" price: the
# streaming rounds run WHILE the workload trains (priced productive,
# surfaced as precopy_s on the migrations list), and only the residual
# pause→final-delta→restore window is downtime, under its own label.
CAUSE_MIGRATION_PRECOPY = "migration_precopy"
CAUSE_MIGRATION_CUTOVER = "migration_cutover"
CAUSE_SLICE_REFORM = "slice_reform"
CAUSE_AGENT_RESTART = "agent_restart"
CAUSE_BIND_QUEUE = "bind_queue"
CAUSE_UNATTRIBUTED = "unattributed"

CAUSES = (
    CAUSE_MAINTENANCE, CAUSE_PREEMPTION, CAUSE_OPERATOR_DRAIN,
    CAUSE_QOS_THROTTLE, CAUSE_QOS_EVICT, CAUSE_MIGRATION,
    CAUSE_MIGRATION_PRECOPY, CAUSE_MIGRATION_CUTOVER,
    CAUSE_SLICE_REFORM, CAUSE_AGENT_RESTART, CAUSE_BIND_QUEUE,
    CAUSE_UNATTRIBUTED,
)


def _drain_category(trigger: str) -> str:
    trigger = str(trigger or "")
    if trigger.startswith("maintenance"):
        return CAUSE_MAINTENANCE
    if trigger.startswith("preemption"):
        return CAUSE_PREEMPTION
    return CAUSE_OPERATOR_DRAIN


def cause_category(event: Optional[dict]) -> str:
    """The {cause} label a claim's triggering journal event rolls up
    under — derived from the event, never free-typed, so the metric's
    label set stays a closed vocabulary (CAUSES)."""
    if event is None:
        return CAUSE_UNATTRIBUTED
    kind = event.get("kind")
    attrs = event.get("attrs", {}) or {}
    if kind == tl.KIND_DRAIN_TRANSITION:
        return _drain_category(attrs.get("trigger"))
    if kind == tl.KIND_THROTTLE:
        return (
            CAUSE_QOS_EVICT if attrs.get("action") == "evict"
            else CAUSE_QOS_THROTTLE
        )
    if kind == tl.KIND_MIGRATION:
        if attrs.get("action") in ("precopy_round", "cutover_signaled"):
            return CAUSE_MIGRATION_PRECOPY
        if attrs.get("action") == "cutover":
            # the replay-synthesized anchor for the pause→final-delta→
            # ack residual of a pre-copy migration; the surrounding
            # MIGRATING window stays plain "migration"
            return CAUSE_MIGRATION_CUTOVER
        return CAUSE_MIGRATION
    if kind == tl.KIND_SLICE_REFORMED:
        return CAUSE_SLICE_REFORM
    if kind == tl.KIND_AGENT_STARTED:
        return CAUSE_AGENT_RESTART
    if kind in (tl.KIND_BIND_INTENT, tl.KIND_BIND_COMMIT,
                tl.KIND_BIND_REPLAY):
        return CAUSE_BIND_QUEUE
    return CAUSE_UNATTRIBUTED


def _cause_ref(event: Optional[dict]) -> Optional[dict]:
    """The resolvable id a non-productive interval carries: the
    triggering event's (node, seq) plus enough context to read it
    without a second lookup."""
    if event is None:
        return None
    return {
        "node": event.get("keys", {}).get("node", ""),
        "seq": event.get("seq"),
        "kind": event.get("kind"),
        "category": cause_category(event),
    }


# -- replay internals ---------------------------------------------------------


class _Claim:
    """One open-or-closed assertion that [start, end) of a pod's life
    was in ``state`` because of ``cause`` (a journal event)."""

    __slots__ = ("state", "start", "end", "cause")

    def __init__(self, state, start, cause, end=None) -> None:
        self.state = state
        self.start = start
        self.end = end  # None = still open
        self.cause = cause


class _Life:
    """One incarnation of a pod key: bind (or anchor) to reclaim."""

    __slots__ = ("start", "end", "committed", "claims", "queue_cause",
                 "slices", "anchored", "precopy_s")

    def __init__(self, start, committed, queue_cause=None,
                 anchored=False) -> None:
        self.start = start
        self.end: Optional[float] = None
        self.committed = committed
        self.claims: List[_Claim] = []
        self.queue_cause = queue_cause
        self.slices: set = set()
        self.anchored = anchored
        # seconds of pre-copy streaming priced PRODUCTIVE (cutover
        # re-anchoring; see the KIND_MIGRATION "recorded" branch)
        self.precopy_s = 0.0

    def open_claim(self, state, start, cause) -> _Claim:
        claim = _Claim(state, start, cause)
        self.claims.append(claim)
        return claim

    def open_of(self, state) -> Optional[_Claim]:
        for claim in self.claims:
            if claim.state == state and claim.end is None:
                return claim
        return None

    def close_state(self, state, ts) -> None:
        for claim in self.claims:
            if claim.state == state and claim.end is None:
                claim.end = ts


def _partition(life: _Life, asof: float) -> List[dict]:
    """Sweep one life's claims into a gap-free, non-overlapping interval
    list — conservation holds by construction: every elementary segment
    between two boundary points gets exactly one state (highest-priority
    active claim, else productive)."""
    start = life.start
    end = life.end if life.end is not None else asof
    if end < start:
        end = start
    claims = []
    for claim in life.claims:
        s = max(start, claim.start)
        e = min(end, claim.end if claim.end is not None else end)
        if e > s:
            claims.append((s, e, claim))
    points = {start, end}
    for s, e, _ in claims:
        points.add(s)
        points.add(e)
    bounds = sorted(points)
    out: List[dict] = []
    for a, b in zip(bounds, bounds[1:]):
        best = None
        for s, e, claim in claims:
            if s <= a and b <= e:
                if best is None or (
                    _PRIORITY[claim.state] > _PRIORITY[best.state]
                ):
                    best = claim
        state = best.state if best is not None else PRODUCTIVE
        cause = _cause_ref(best.cause) if best is not None else None
        if out and out[-1]["state"] == state and out[-1]["cause"] == cause:
            out[-1]["end"] = b  # merge adjacent same-state segments
        else:
            out.append({
                "state": state, "start": a, "end": b, "cause": cause,
            })
    return out


def replay_goodput(
    rows: List[dict],
    asof: float,
    anchors: Optional[dict] = None,
    acks: Optional[Dict[str, float]] = None,
) -> dict:
    """Pure replay: journal rows (one node's, or a ts-merged fleet view
    — every row carries its node in keys) -> per-pod goodput ledgers.

    ``anchors`` is the agent_state-journaled {"pods": {pod: {"start":
    ts}}, "last_alive_ts": ts} block: lifetime starts for pods whose
    bind events the ring has evicted, plus the heartbeat that bounds a
    crash window when the journal went quiet before the crash. ``acks``
    is {pod: latest checkpoint-ack ts} (the migration coordinator's
    view, or read from the ack sidecars) — it closes reform-triggered
    checkpointing claims, the one transition with no journal event of
    its own.
    """
    anchors = anchors or {}
    acks = acks or {}
    by_node: Dict[str, List[dict]] = {}
    for row in rows:
        by_node.setdefault(row.get("keys", {}).get("node", ""), []).append(
            row
        )
    if not by_node and anchors.get("pods"):
        by_node[""] = []
    pods_out: Dict[str, dict] = {}
    migrations: List[dict] = []
    # Anchors belong to ONE node's ledger (they ride its agent_state);
    # in a merged multi-node replay they seed only their own node.
    anchor_node = anchors.get("node")
    for node, node_rows in by_node.items():
        lives: Dict[str, _Life] = {}
        done: Dict[str, List[_Life]] = {}
        seed_anchors = (
            len(by_node) == 1
            or (anchor_node is not None and node == anchor_node)
        )
        # Anchored pods pre-seed their lives: the ring may have trimmed
        # their bind events, but the ledger journaled where they began.
        for pod, anchor in (
            (anchors.get("pods") or {}) if seed_anchors else {}
        ).items():
            try:
                lives[pod] = _Life(
                    float(anchor["start"]), True, anchored=True
                )
            except (KeyError, TypeError, ValueError):
                continue
        drain_open: Optional[dict] = None  # the standing drain event
        last_alive = anchors.get("last_alive_ts")
        prev_ts: Optional[float] = None

        def _end_life(pod: str, ts: float) -> None:
            life = lives.pop(pod, None)
            if life is None:
                return
            life.end = ts
            for claim in life.claims:
                if claim.end is None:
                    claim.end = ts
            done.setdefault(pod, []).append(life)

        for ev in node_rows:
            ts = ev.get("ts", 0.0)
            kind = ev.get("kind")
            keys = ev.get("keys", {}) or {}
            attrs = ev.get("attrs", {}) or {}
            pod = keys.get("pod")
            if kind == tl.KIND_BIND_INTENT:
                if pod:
                    prior = lives.get(pod)
                    if prior is not None and prior.anchored:
                        # The ring still holds this incarnation's bind
                        # events (or the anchor is stale across a
                        # trimmed reclaim): the real events supersede
                        # the journaled anchor, or tick N would lose
                        # the queued window tick 1 priced.
                        if ts > prior.start:
                            _end_life(pod, ts)
                        else:
                            del lives[pod]
                    if pod not in lives:
                        lives[pod] = _Life(ts, False, queue_cause=ev)
                    if keys.get("slice"):
                        lives[pod].slices.add(keys["slice"])
            elif kind in (tl.KIND_BIND_COMMIT, tl.KIND_BIND_REPLAY):
                if not pod:
                    pass
                elif pod not in lives:
                    life = lives[pod] = _Life(ts, True)
                    if drain_open is not None:
                        life.open_claim(DRAINING, ts, drain_open)
                else:
                    life = lives[pod]
                    if not life.committed:
                        life.committed = True
                        life.open_claim(
                            QUEUED, life.start, life.queue_cause or ev
                        ).end = ts
                        if drain_open is not None:
                            life.open_claim(DRAINING, ts, drain_open)
                if pod and keys.get("slice"):
                    lives[pod].slices.add(keys["slice"])
            elif kind == tl.KIND_BIND_ROLLBACK:
                if pod in lives and not lives[pod].committed:
                    life = lives[pod]
                    life.open_claim(
                        QUEUED, life.start, life.queue_cause or ev
                    ).end = ts
                    _end_life(pod, ts)
            elif kind == tl.KIND_POD_RECLAIMED:
                if pod:
                    _end_life(pod, ts)
            elif kind == tl.KIND_RECONCILE_REPAIR:
                if pod and attrs.get("class") == "reclaimed_pod":
                    _end_life(pod, ts)
            elif kind == tl.KIND_DRAIN_TRANSITION:
                state = attrs.get("state")
                if state == "draining":
                    drain_open = ev
                    for life in lives.values():
                        if life.committed and life.open_of(DRAINING) is None:
                            life.open_claim(DRAINING, ts, ev)
                elif state in ("active", "drained", "reclaimed"):
                    # cancel, or every resident already left: the signal
                    # no longer claims anyone still alive (checkpointing
                    # claims need no closing here — they are always
                    # created with their ack-derived end already set)
                    for life in lives.values():
                        life.close_state(DRAINING, ts)
                    drain_open = None
            elif kind == tl.KIND_THROTTLE:
                action = attrs.get("action")
                if pod in lives:
                    life = lives[pod]
                    if action == "throttle":
                        if life.open_of(THROTTLED) is None:
                            life.open_claim(THROTTLED, ts, ev)
                    elif action == "unthrottle":
                        life.close_state(THROTTLED, ts)
                    elif action == "evict":
                        life.close_state(THROTTLED, ts)
                        # evict window: clamp stays until the reclaim
                        life.open_claim(THROTTLED, ts, ev)
            elif kind == tl.KIND_MIGRATION:
                action = attrs.get("action")
                if action == "recorded" and pod in lives:
                    life = lives[pod]
                    signal = (
                        life.open_of(DRAINING) or life.open_of(THROTTLED)
                    )
                    if signal is not None and ts > signal.start:
                        # the checkpoint the signal asked for: signal ..
                        # ack, attributed to the TRIGGER (maintenance,
                        # preemption, throttle), not to the handshake
                        ck_start, ck_cause = signal.start, signal.cause
                        cut_ts = attrs.get("cutover_ts")
                        if (
                            attrs.get("mode") == "precopy"
                            and isinstance(cut_ts, (int, float))
                        ):
                            # pre-copy streamed WHILE training: the
                            # window before cutover stays PRODUCTIVE
                            # (the drain claim re-anchors at cutover);
                            # only the residual pause→final-delta→ack
                            # is downtime, under migration_cutover
                            cut = min(
                                max(float(cut_ts), signal.start), ts
                            )
                            life.precopy_s += cut - signal.start
                            signal.start = cut
                            ck_start = cut
                            ck_cause = dict(
                                ev, attrs={**attrs, "action": "cutover"}
                            )
                        life.open_claim(
                            CHECKPOINTING, ck_start, ck_cause
                        ).end = ts
                    if life.open_of(MIGRATING) is None:
                        life.open_claim(MIGRATING, ts, ev)
                elif action == "early_reclaim" and pod:
                    if pod in lives and lives[pod].open_of(MIGRATING) is None:
                        lives[pod].open_claim(MIGRATING, ts, ev)
                    _end_life(pod, ts)
                elif action == "restore_stamped" and pod in lives:
                    life = lives[pod]
                    if life.open_of(MIGRATING) is None:
                        # the whole admission-to-resume window is the
                        # migration's: the replacement was restoring
                        life.open_claim(MIGRATING, life.start, ev)
                elif action == "completed" and pod in lives:
                    lives[pod].close_state(MIGRATING, ts)
                    migrations.append({
                        "pod": pod,
                        "node": node,
                        "completed_ts": ts,
                        "source_node": attrs.get("source_node"),
                        "coordinator_downtime_s": attrs.get("downtime_s"),
                        "step": attrs.get("step"),
                        "mode": attrs.get("mode", "full"),
                        "precopy": attrs.get("precopy"),
                    })
            elif kind == tl.KIND_SLICE_REFORMED:
                if pod in lives:
                    life = lives[pod]
                    if keys.get("slice"):
                        life.slices.add(keys["slice"])
                    ack_ts = acks.get(pod)
                    if ack_ts is not None and ack_ts > ts:
                        life.open_claim(CHECKPOINTING, ts, ev).end = min(
                            ack_ts, asof
                        )
            elif kind == tl.KIND_AGENT_STARTED:
                if prev_ts is not None:
                    gap_start = prev_ts
                    if (
                        isinstance(last_alive, (int, float))
                        and prev_ts < last_alive < ts
                    ):
                        gap_start = float(last_alive)
                    for life in lives.values():
                        if life.committed and gap_start < ts:
                            life.open_claim(
                                UNATTRIBUTED, max(gap_start, life.start),
                                ev,
                            ).end = ts
            prev_ts = ts
        # Close the books at asof.
        for pod, life in list(lives.items()):
            done.setdefault(pod, []).append(life)
        for pod, pod_lives in done.items():
            entry = pods_out.setdefault(pod, {
                "node": node,
                "intervals": [],
                "states": {s: 0.0 for s in STATES},
                "lifetime_s": 0.0,
                "live": False,
                "live_start": None,
                "slices": set(),
                "anchored": False,
                "precopy_s": 0.0,
            })
            for life in pod_lives:
                intervals = _partition(life, asof)
                entry["intervals"].extend(intervals)
                for itv in intervals:
                    entry["states"][itv["state"]] += (
                        itv["end"] - itv["start"]
                    )
                end = life.end if life.end is not None else asof
                entry["lifetime_s"] += max(0.0, end - life.start)
                if life.end is None:
                    entry["live"] = True
                    entry["live_start"] = life.start
                entry["slices"] |= life.slices
                entry["anchored"] = entry["anchored"] or life.anchored
                entry["precopy_s"] += life.precopy_s
    downtime: Dict[str, float] = {}
    for pod, entry in pods_out.items():
        entry["slices"] = sorted(entry["slices"])
        entry["states"] = {
            s: round(v, 6) for s, v in entry["states"].items()
        }
        lifetime = entry["lifetime_s"]
        entry["lifetime_s"] = round(lifetime, 6)
        entry["precopy_s"] = round(entry["precopy_s"], 6)
        entry["goodput_ratio"] = (
            round(entry["states"][PRODUCTIVE] / lifetime, 6)
            if lifetime > 0 else None
        )
        for itv in entry["intervals"]:
            if itv["state"] == PRODUCTIVE:
                continue
            cat = (
                itv["cause"]["category"] if itv["cause"]
                else CAUSE_UNATTRIBUTED
            )
            downtime[cat] = (
                downtime.get(cat, 0.0) + itv["end"] - itv["start"]
            )
    return {
        "asof": asof,
        "pods": pods_out,
        "downtime_by_cause": {
            k: round(v, 6) for k, v in sorted(downtime.items())
        },
        "migrations": migrations,
        "events_replayed": len(rows),
    }


def verify_conservation(
    result: dict, rows: Optional[List[dict]] = None
) -> List[str]:
    """The invariant the property tests and the goodput smoke pin;
    returns problems (empty = conservation holds):

    - per pod, interval durations sum to the pod's lifetime (gap-free);
    - intervals never overlap (each is strictly after the previous);
    - every non-productive interval except ``unattributed`` carries a
      cause, and when ``rows`` is given every cause (node, seq)
      resolves to a surviving journal event.
    """
    problems: List[str] = []
    known = None
    if rows is not None:
        # the same (node, seq) identity timeline.event_by_ref resolves —
        # set-built here because this check runs over EVERY interval
        known = {
            (e.get("keys", {}).get("node", ""), e.get("seq"))
            for e in rows
        }
    for pod, entry in result.get("pods", {}).items():
        covered = 0.0
        prev_end = None
        for itv in entry["intervals"]:
            if itv["end"] < itv["start"]:
                problems.append(
                    f"{pod}: negative interval {itv['start']}..{itv['end']}"
                )
            if prev_end is not None and itv["start"] < prev_end - 1e-9:
                problems.append(
                    f"{pod}: interval overlap at {itv['start']} "
                    f"(previous ends {prev_end})"
                )
            prev_end = max(prev_end or itv["end"], itv["end"])
            covered += itv["end"] - itv["start"]
            if itv["state"] in (PRODUCTIVE, UNATTRIBUTED):
                continue
            cause = itv.get("cause")
            if cause is None:
                problems.append(
                    f"{pod}: {itv['state']} interval at {itv['start']} "
                    "carries no cause"
                )
            elif known is not None and (
                (cause.get("node", ""), cause.get("seq")) not in known
            ):
                problems.append(
                    f"{pod}: cause seq {cause.get('seq')} on "
                    f"{cause.get('node')!r} does not resolve in the "
                    "journal"
                )
        if abs(covered - entry["lifetime_s"]) > 1e-6:
            problems.append(
                f"{pod}: intervals cover {covered:.6f}s of a "
                f"{entry['lifetime_s']:.6f}s lifetime"
            )
    return problems


# -- the agent-side ledger ----------------------------------------------------


class GoodputLedger:
    """Supervised (DEGRADED) replay loop over the node's own journal.

    Each tick re-derives the partition from the durable timeline — the
    journal is the single source of truth, so a restarted agent's first
    tick reproduces the same ledger — then journals its anchors
    (lifetime starts + a last-alive heartbeat) into ``agent_state`` so
    eviction and crashes cannot orphan long-lived pods' lifetimes, and
    exports ``elastic_tpu_goodput_ratio{pod}`` plus
    ``elastic_tpu_downtime_seconds_total{cause}``.
    """

    def __init__(
        self,
        storage,
        node_name: str = "",
        metrics=None,
        migration=None,
        period_s: float = DEFAULT_PERIOD_S,
        clock=None,
        lag_tracker=None,
    ) -> None:
        self._storage = storage
        self._node = node_name
        self._metrics = metrics
        self._migration = migration
        self.period_s = period_s
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._anchors: dict = {}
        self._last: Optional[dict] = None
        self._exported_pods: set = set()
        self.ticks_total = 0
        # DetectionLagTracker (latency.py): the ledger's event source is
        # the journal itself — lag = newest row's ts to the tick that
        # replayed it, watermarked so each row generation counts once.
        self._lag = lag_tracker
        self._row_watermark = float("-inf")

    # -- restart durability ---------------------------------------------------

    def resume(self) -> None:
        """Reload journaled anchors (boot path, before the first tick):
        pods whose bind events the ring already trimmed keep the
        lifetime starts the previous process learned."""
        try:
            state = self._storage.load_state(_STATE_KEY)
        except Exception:  # noqa: BLE001 - observability, never fatal
            logger.exception("goodput: anchor resume failed")
            return
        if isinstance(state, dict):
            with self._lock:
                self._anchors = state

    def _journal_anchors(self, result: dict, asof: float) -> None:
        anchors = {
            "node": self._node,
            "pods": {},
            "last_alive_ts": asof,
        }
        for pod, entry in result["pods"].items():
            if not entry["live"]:
                continue
            start = entry.get("live_start")
            if start is not None:
                anchors["pods"][pod] = {"start": start}
        with self._lock:
            self._anchors = anchors
        try:
            self._storage.save_state(_STATE_KEY, anchors)
        except Exception:  # noqa: BLE001 - the ledger must never wedge
            logger.warning("goodput: anchor journal write failed")

    # -- one tick -------------------------------------------------------------

    def tick(self) -> dict:
        asof = self._clock.time()
        rows = self._storage.timeline_rows()
        if self._lag is not None and rows:
            try:
                newest = max(float(e.get("ts", 0.0)) for e in rows)
                if newest > self._row_watermark:
                    self._row_watermark = newest
                    self._lag.handled(
                        "goodput", "journal_replay", origin_ts=newest
                    )
            except Exception:  # noqa: BLE001 - accounting never breaks
                pass
        acks: Dict[str, float] = {}
        if self._migration is not None:
            try:
                acks = dict(self._migration.acked_pods())
            except Exception:  # noqa: BLE001 - acks only refine reforms
                acks = {}
        with self._lock:
            anchors = dict(self._anchors)
        result = replay_goodput(rows, asof, anchors=anchors, acks=acks)
        self._journal_anchors(result, asof)
        self._export(result)
        with self._lock:
            self._last = result
            self.ticks_total += 1
        return result

    def _export(self, result: dict) -> None:
        m = self._metrics
        if m is None:
            return
        try:
            live = set()
            for pod, entry in result["pods"].items():
                if entry["goodput_ratio"] is None or not entry["live"]:
                    continue
                live.add(pod)
                if hasattr(m, "goodput_ratio"):
                    m.goodput_ratio.set(entry["goodput_ratio"], pod=pod)
            if hasattr(m, "goodput_ratio"):
                for gone in self._exported_pods - live:
                    m.goodput_ratio.remove(pod=gone)
            self._exported_pods = live
            if hasattr(m, "downtime_seconds"):
                for cause in CAUSES:
                    m.downtime_seconds.labels(cause=cause).set(
                        result["downtime_by_cause"].get(cause, 0.0)
                    )
        except Exception:  # noqa: BLE001 - metrics never break the ledger
            logger.exception("goodput metrics export failed")

    # -- read surfaces --------------------------------------------------------

    def status(
        self, pod: Optional[str] = None, since: Optional[float] = None
    ) -> dict:
        """The ``goodput`` block shared by /debug/goodput, the doctor
        bundle and the fleet aggregator. Computes a fresh replay when no
        tick has run yet (endpoint attached before the loop started)."""
        with self._lock:
            result = self._last
        if result is None:
            try:
                result = self.tick()
            except Exception as e:  # noqa: BLE001 - a read must not raise
                return {
                    "node": self._node, "error": str(e), "pods": {},
                    "downtime_by_cause": {}, "migrations": [],
                    # every caller indexes these; the failed tick must
                    # surface as ITS error, not a KeyError downstream
                    "conservation_problems": [
                        f"ledger tick failed: {e}"
                    ],
                    "ticks_total": self.ticks_total,
                    "anchored_pods": 0,
                }
        payload = select_pods(result, pod=pod, since=since)
        payload["node"] = self._node
        payload["conservation_problems"] = verify_conservation(payload)
        with self._lock:
            payload["ticks_total"] = self.ticks_total
            payload["anchored_pods"] = len(
                (self._anchors.get("pods") or {})
            )
        return payload

    # -- the supervised loop --------------------------------------------------

    def run(self, stop: threading.Event) -> None:
        import random

        while not stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - supervised: log and retick
                logger.exception("goodput tick failed")
            if stop.wait(self.period_s * (0.75 + 0.5 * random.random())):
                return


def select_pods(
    result: dict,
    pod: Optional[str] = None,
    slice_id: Optional[str] = None,
    since: Optional[float] = None,
) -> dict:
    """Filter one replay result to an entity/time window, recomputing
    the downtime rollup over what survives. ``pod`` accepts bare names
    like the trace and timeline filters do; ``since`` keeps pods whose
    lifetime reaches past the bound (their full partition is kept — a
    clipped partition would break conservation)."""
    pods = {}
    for key, entry in result.get("pods", {}).items():
        if pod is not None and key != pod and (
            key.rpartition("/")[2] != pod
        ):
            continue
        if slice_id is not None and slice_id not in entry.get(
            "slices", []
        ):
            continue
        if since is not None:
            last_end = (
                entry["intervals"][-1]["end"] if entry["intervals"]
                else None
            )
            if last_end is None or last_end < since:
                continue
        pods[key] = entry
    downtime: Dict[str, float] = {}
    for entry in pods.values():
        for itv in entry["intervals"]:
            if itv["state"] == PRODUCTIVE:
                continue
            cat = (
                itv["cause"]["category"] if itv["cause"]
                else CAUSE_UNATTRIBUTED
            )
            downtime[cat] = (
                downtime.get(cat, 0.0) + itv["end"] - itv["start"]
            )
    return {
        "asof": result.get("asof"),
        "pods": pods,
        "downtime_by_cause": {
            k: round(v, 6) for k, v in sorted(downtime.items())
        },
        "migrations": [
            m for m in result.get("migrations", [])
            if pod is None or m.get("pod") == pod
            or str(m.get("pod", "")).rpartition("/")[2] == pod
        ],
        "events_replayed": result.get("events_replayed"),
    }


def build_goodput_block(
    storage,
    asof: Optional[float] = None,
    pod: Optional[str] = None,
    slice_id: Optional[str] = None,
    since: Optional[float] = None,
) -> dict:
    """The dead-agent read path (node-doctor, doctor bundle): replay the
    db's journal + journaled anchors with NO live process. ``asof``
    defaults to the ledger's knowledge horizon — the later of the last
    journal event and the last anchor heartbeat — so a dead agent's
    silent hours never count as productive time."""
    rows = storage.timeline_rows()
    try:
        anchors = storage.load_state(_STATE_KEY) or {}
    except Exception:  # noqa: BLE001 - a bundle beats no bundle
        anchors = {}
    if asof is None:
        candidates = [e.get("ts", 0.0) for e in rows]
        if isinstance(anchors.get("last_alive_ts"), (int, float)):
            candidates.append(float(anchors["last_alive_ts"]))
        asof = max(candidates) if candidates else 0.0
    result = replay_goodput(rows, asof, anchors=anchors)
    payload = select_pods(
        result, pod=pod, slice_id=slice_id, since=since
    )
    payload["conservation_problems"] = verify_conservation(payload, rows)
    payload["anchored_pods"] = len((anchors.get("pods") or {}))
    return payload


def validate_goodput_block(block: dict) -> List[str]:
    """Schema check for the ``goodput`` doctor-bundle block (consumed by
    sampler.validate_bundle); returns problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(block, dict):
        return ["goodput must be an object"]
    for field in ("asof", "pods", "downtime_by_cause"):
        if field not in block:
            problems.append(f"goodput missing {field!r}")
    pods = block.get("pods")
    if not isinstance(pods, dict):
        problems.append("goodput.pods must be an object")
        pods = {}
    for key, entry in pods.items():
        if not isinstance(entry, dict):
            problems.append(f"goodput.pods[{key!r}] must be an object")
            continue
        for field in ("intervals", "states", "lifetime_s",
                      "goodput_ratio", "live"):
            if field not in entry:
                problems.append(
                    f"goodput.pods[{key!r}] missing {field!r}"
                )
        states = entry.get("states")
        if isinstance(states, dict):
            for s in STATES:
                if s not in states:
                    problems.append(
                        f"goodput.pods[{key!r}].states missing {s!r}"
                    )
        for i, itv in enumerate(entry.get("intervals") or []):
            if not isinstance(itv, dict):
                problems.append(
                    f"goodput.pods[{key!r}].intervals[{i}] must be an "
                    "object"
                )
                continue
            if itv.get("state") not in STATES:
                problems.append(
                    f"goodput.pods[{key!r}].intervals[{i}].state "
                    f"{itv.get('state')!r} is not a goodput state"
                )
            for field in ("start", "end"):
                if not isinstance(itv.get(field), (int, float)):
                    problems.append(
                        f"goodput.pods[{key!r}].intervals[{i}].{field} "
                        "must be a number"
                    )
    causes = block.get("downtime_by_cause")
    if not isinstance(causes, dict):
        problems.append("goodput.downtime_by_cause must be an object")
    else:
        for cause, seconds in causes.items():
            if cause not in CAUSES:
                problems.append(
                    f"goodput.downtime_by_cause key {cause!r} is not a "
                    "known cause"
                )
            if not isinstance(seconds, (int, float)):
                problems.append(
                    f"goodput.downtime_by_cause[{cause!r}] must be a "
                    "number"
                )
    return problems
