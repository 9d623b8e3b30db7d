"""In-process event bus: the agent's poll-to-push seam.

The port's copy of ``elastic_tpu_agent/events.py``. The state sources push
instead of every loop polling on its jittered period:

- the kube sitter publishes **pod deltas** straight off the apiserver
  watch stream (:data:`POD_DELTA`);
- ``PodResourcesSnapshotSource`` publishes **assignment deltas** from
  kubelet List diffs (:data:`ASSIGNMENT_DELTA`);
- ``Storage`` publishes **store-change notifications** (bind commits,
  intent open/close, agent_state writes) after their commit has landed
  (:data:`STORE_BIND`, :data:`STORE_INTENT`, :data:`STORE_STATE`);

and the reconciler subscribes and runs *targeted* passes on relevant
events, with its jittered periodic sweep demoted to a safety net (the
period stretched by ``event_safety_net_factor`` while the bus is healthy;
still the correctness backstop, never removed).

Design contract (the agent's ``tests/test_event_bus.py`` pins each clause,
``tests/test_torch_events.py`` holds this copy to the agent's):

- **Publishers never block and never fail.** ``publish`` is O(number of
  subscribers) and takes only short internal locks: a full subscriber
  queue drops the OLDEST pending event and counts the drop; a crashing
  callback subscriber is counted and logged, never propagated.
- **Bounded queues.** Every subscription has a hard queue cap. A slow
  consumer degrades to "wake up and resweep" (it keeps the newest events
  and its drop counter says how many it missed); it never exerts
  backpressure on the bind path or the watch stream.
- **ManualClock-testable.** Events are stamped from the injected clock
  and carry a global monotone sequence number.
- **Degraded mode is loud.** A source that loses its push feed (the watch
  stream dies) flips :meth:`EventBus.set_degraded`; the bus wakes EVERY
  subscriber with a :data:`BUS_WAKE` event so that loops fall back to
  their base (unstretched) period at once.

The bus is optional everywhere: every integration point accepts
``bus=None`` and degenerates to the plain polling behavior (the agent's
``--no-event-bus``).
"""

from __future__ import annotations

import logging
import threading
import time as _time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

from .common import SYSTEM_CLOCK

logger = logging.getLogger(__name__)

# -- topic vocabulary ----------------------------------------------------------

#: Apiserver watch-stream pod changes (kinds: "added", "modified",
#: "deleted", "relist-gone"); key = "namespace/name".
POD_DELTA = "pod.delta"

#: Kubelet pod-resources List diffs (kinds: "added", "removed",
#: "owner-changed"); key = allocation hash.
ASSIGNMENT_DELTA = "assignment.delta"

#: Durable pod-record changes — the bind commit marker (kinds: "save",
#: "delete"); key = "namespace/name". Published AFTER the covering
#: commit has landed (group-commit flush path), never before.
STORE_BIND = "store.bind"

#: Bind-intent journal rows (kinds: "open", "close"); key = intent id.
STORE_INTENT = "store.intent"

#: agent_state lifecycle journal writes (kinds: "save", "delete");
#: key = state key.
STORE_STATE = "store.state"

#: Bus-health wakeup broadcast to ALL subscribers regardless of topic
#: filter (kinds: "degraded", "recovered"); key = source name. Loops
#: use it to recompute their safety-net stretch immediately.
BUS_WAKE = "bus.wake"

ALL_TOPICS = (
    POD_DELTA, ASSIGNMENT_DELTA, STORE_BIND, STORE_INTENT, STORE_STATE,
    BUS_WAKE,
)

#: Per-subscription queue cap when the subscriber doesn't choose one.
#: Sized so a full churn burst fits; overflow is counted,
#: not fatal (the periodic safety-net sweep repairs whatever a dropped
#: event would have pointed at).
DEFAULT_QUEUE_CAP = 512

# wait_trigger() slices its waits so a stop request is honored promptly
# even while blocked on the ready event.
_WAIT_SLICE_S = 0.1


class Event:
    """One published event. Immutable by convention; ``payload`` is a
    small dict of primitives (subscribers must treat it read-only)."""

    __slots__ = ("topic", "kind", "key", "ts", "seq", "payload")

    def __init__(self, topic: str, kind: str, key: str, ts: float,
                 seq: int, payload: dict) -> None:
        self.topic = topic
        self.kind = kind
        self.key = key
        self.ts = ts
        self.seq = seq
        self.payload = payload

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Event(seq={self.seq}, topic={self.topic!r}, "
                f"kind={self.kind!r}, key={self.key!r})")


class Subscription:
    """One subscriber's bounded mailbox (or callback) on the bus.

    Queue mode (``callback=None``): events buffer in a bounded deque;
    the consumer calls :meth:`drain` (all pending, publish order) and
    typically blocks in :meth:`wait_trigger` between passes. Overflow
    drops the OLDEST event and increments :attr:`drops`.

    Callback mode: ``callback(event)`` runs inline on the publisher's
    thread — keep it O(microseconds); exceptions are counted in
    :attr:`callback_errors` and never reach the publisher.
    """

    def __init__(self, bus: "EventBus", name: str, topics: Iterable[str],
                 cap: int, callback: Optional[Callable[[Event], None]] = None,
                 ) -> None:
        self.bus = bus
        self.name = name
        self.topics = frozenset(topics)
        self.cap = max(1, int(cap))
        self.callback = callback
        self._lock = threading.Lock()
        self._buf: deque = deque()
        self._ready = threading.Event()
        self.delivered = 0
        self.drops = 0
        self.callback_errors = 0
        self._closed = False

    # -- publisher side (called by EventBus only) -----------------------------

    def _offer(self, event: Event) -> None:
        if self._closed:
            return
        if self.callback is not None:
            try:
                self.callback(event)
                with self._lock:
                    self.delivered += 1
            except Exception:  # noqa: BLE001 - isolate from publisher
                with self._lock:
                    self.callback_errors += 1
                logger.exception("event subscriber %r callback failed on %r",
                                 self.name, event)
            return
        with self._lock:
            if len(self._buf) >= self.cap:
                self._buf.popleft()
                self.drops += 1
            self._buf.append(event)
            self.delivered += 1
        self._ready.set()

    # -- consumer side --------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def drain(self) -> List[Event]:
        """All buffered events in publish order; clears the mailbox and
        the ready flag."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            self._ready.clear()
        return out

    def wait_trigger(self, stop: Optional[threading.Event],
                     timeout_s: float) -> str:
        """Block until an event arrives, ``stop`` is set, or
        ``timeout_s`` elapses — returns ``"event"``, ``"stop"`` or
        ``"poll"`` so loops can thread the trigger into their pass (and
        into detection-lag attribution). Pending undrained events fire
        immediately."""
        deadline = _time.monotonic() + max(0.0, timeout_s)
        while True:
            if stop is not None and stop.is_set():
                return "stop"
            if self._ready.is_set():
                return "event"
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return "poll"
            self._ready.wait(timeout=min(remaining, _WAIT_SLICE_S))

    def close(self) -> None:
        self.bus.unsubscribe(self)

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "topics": sorted(self.topics),
                "cap": self.cap,
                "pending": len(self._buf),
                "delivered": self.delivered,
                "drops": self.drops,
                "callback_errors": self.callback_errors,
                "mode": "callback" if self.callback is not None else "queue",
            }


class EventBus:
    """Topic-filtered fan-out with bounded per-subscriber queues.

    One bus per agent process, constructed by the manager before any
    subsystem and handed to sources (publish) and loops (subscribe).
    Thread-safe throughout; ``publish`` never raises and never blocks
    beyond short internal critical sections.
    """

    def __init__(self, clock=None, default_cap: int = DEFAULT_QUEUE_CAP,
                 ) -> None:
        self._clock = clock if clock is not None else SYSTEM_CLOCK
        self._default_cap = max(1, int(default_cap))
        self._lock = threading.Lock()
        self._subs: List[Subscription] = []
        self._seq = 0
        self._degraded: set = set()
        # chaos seam: {topic: remaining count} of publishes to swallow
        # (counted in suppressed_total) — lets the event smoke prove the
        # safety-net sweep catches a dropped event.
        self._suppress: Dict[str, int] = {}
        self.published_total = 0
        self.published_by_topic: Dict[str, int] = {}
        self.suppressed_total = 0

    # -- subscription ---------------------------------------------------------

    def subscribe(self, name: str, topics: Iterable[str],
                  cap: Optional[int] = None,
                  callback: Optional[Callable[[Event], None]] = None,
                  ) -> Subscription:
        for t in topics:
            if t not in ALL_TOPICS:
                raise ValueError(f"unknown event topic {t!r}")
        sub = Subscription(self, name, topics,
                           cap if cap is not None else self._default_cap,
                           callback=callback)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            sub._closed = True
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    # -- publishing -----------------------------------------------------------

    def publish(self, topic: str, kind: str = "", key: str = "",
                payload: Optional[dict] = None) -> int:
        """Fan one event out to every matching subscriber; returns the
        number of subscribers it reached. Never raises, never blocks a
        publisher on a slow consumer."""
        with self._lock:
            left = self._suppress.get(topic, 0)
            if left > 0:
                self._suppress[topic] = left - 1
                self.suppressed_total += 1
                return 0
            self._seq += 1
            event = Event(topic, kind, key, self._clock.time(), self._seq,
                          payload if payload is not None else {})
            self.published_total += 1
            self.published_by_topic[topic] = (
                self.published_by_topic.get(topic, 0) + 1
            )
            if topic == BUS_WAKE:
                targets = list(self._subs)
            else:
                targets = [s for s in self._subs if topic in s.topics]
        for sub in targets:
            sub._offer(event)
        return len(targets)

    # -- degraded mode (no-gap fallback) --------------------------------------

    def set_degraded(self, source: str, degraded: bool) -> None:
        """A push source reporting loss (or recovery) of its feed.
        Transitions broadcast :data:`BUS_WAKE` to ALL subscribers so
        every loop immediately recomputes its safety-net stretch —
        a dying watch stream must shrink sweep periods NOW, not after
        the currently armed (stretched) wait runs out."""
        with self._lock:
            was = bool(self._degraded)
            if degraded:
                changed = source not in self._degraded
                self._degraded.add(source)
            else:
                changed = source in self._degraded
                self._degraded.discard(source)
            now = bool(self._degraded)
        if changed:
            logger.warning("event bus source %r %s (degraded sources: %s)",
                           source, "degraded" if degraded else "recovered",
                           "yes" if now else "none")
        if changed and was != now:
            self.publish(BUS_WAKE,
                         kind="degraded" if now else "recovered",
                         key=source)

    def healthy(self) -> bool:
        """True while every push source is feeding the bus — the
        precondition for loops to stretch their periodic sweep."""
        with self._lock:
            return not self._degraded

    def degraded_sources(self) -> List[str]:
        with self._lock:
            return sorted(self._degraded)

    # -- chaos seam -----------------------------------------------------------

    def suppress(self, topic: str, count: int = 1) -> None:
        """Swallow the next ``count`` publishes on ``topic`` (counted in
        ``suppressed_total``). Chaos/test seam: proves the safety-net
        sweep repairs what a dropped event would have pointed at."""
        with self._lock:
            self._suppress[topic] = self._suppress.get(topic, 0) + int(count)

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            subs = list(self._subs)
            out = {
                "published_total": self.published_total,
                "published_by_topic": dict(self.published_by_topic),
                "suppressed_total": self.suppressed_total,
                "degraded_sources": sorted(self._degraded),
                "subscribers": [],
            }
        out["subscribers"] = [s.stats() for s in subs]
        out["drops_total"] = sum(s["drops"] for s in out["subscribers"])
        return out
