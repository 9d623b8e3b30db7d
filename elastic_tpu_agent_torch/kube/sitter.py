"""Sitter: node-filtered pod cache with a delete hook feeding GC.

The port's copy of ``elastic_tpu_agent/kube/sitter.py``. With an event bus
(events.py) it publishes pod deltas straight off the watch stream
(``POD_DELTA``) and flips the bus degraded while the watch is down.

Capability parity with the reference's ``pkg/kube/sitter.go`` (SURVEY.md §1
L5): an informer-style list+watch over the pods bound to this node, a read
cache (get_pod), apiserver fallbacks (get_pod_from_api /
get_node_from_api), has_synced, and a DeleteFunc hook that forwards pod
deletions to the manager's GC channel.

Instead of the reference's 1-second full resync (sitter.go:61, papering
over watch staleness), we run a real watch with re-list on expiry plus a
periodic safety re-list.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .. import events as events_mod
from .. import faults
from ..common import JitteredBackoff
from .client import KubeClient, KubeError

logger = logging.getLogger(__name__)

DeleteHook = Callable[[dict], None]

# list/watch failure backoff: jittered exponential instead of the old
# fixed 1.0s — a dead apiserver must not be hammered once a second by
# every node's agent in lockstep, and recovery still starts fast.
RETRY_MIN_S = 1.0
RETRY_MAX_S = 30.0


class Sitter:
    def __init__(
        self,
        client: KubeClient,
        node_name: str,
        on_delete: Optional[DeleteHook] = None,
        relist_interval_s: float = 30.0,
        bus=None,
    ) -> None:
        self._client = client
        self._node = node_name
        self._on_delete = on_delete
        self._relist_s = relist_interval_s
        # Event bus (events.EventBus, optional): pod deltas publish on
        # POD_DELTA straight off the watch stream; a dead list/watch
        # flips the bus degraded so every subscribed loop collapses its
        # stretched safety-net sweep back to the base period with no
        # coverage gap (the AsyncSink/brownout fix — see run()).
        self._bus = bus
        self._lock = threading.RLock()
        self._cache: Dict[Tuple[str, str], dict] = {}
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # monotonic timestamp of the last successful apiserver contact
        # (relist success or watch event); 0.0 = never. Staleness is
        # surfaced via /healthz and elastic_tpu_sitter_sync_age_seconds
        # so a long apiserver outage is visible instead of silent cache
        # rot.
        self._last_sync_monotonic = 0.0

    # -- cache reads ----------------------------------------------------------

    def wait_synced(self, timeout: Optional[float] = None) -> bool:
        return self._synced.wait(timeout)

    def sync_age_s(self) -> Optional[float]:
        """Seconds since the cache last heard from the apiserver, or None
        before the first successful list."""
        last = self._last_sync_monotonic
        if last == 0.0:
            return None
        return max(0.0, time.monotonic() - last)

    def get_pod(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._cache.get((namespace, name))

    def pods(self) -> list:
        with self._lock:
            return list(self._cache.values())

    # -- apiserver fallbacks (reference: sitter.go GetPodFromApiServer) -------

    def get_pod_from_api(self, namespace: str, name: str) -> Optional[dict]:
        return self._client.get_pod(namespace, name)

    def get_node_from_api(self, name: str) -> Optional[dict]:
        return self._client.get_node(name)

    # -- list+watch loop ------------------------------------------------------

    @staticmethod
    def _key(pod: dict) -> Tuple[str, str]:
        md = pod.get("metadata", {})
        return md.get("namespace", ""), md.get("name", "")

    def _relist(self) -> str:
        faults.fire("sitter.relist")
        items, rv = self._client.list_pods(self._node)
        fresh = {self._key(p): p for p in items}
        with self._lock:
            gone = set(self._cache) - set(fresh)
            gone_pods = [self._cache[k] for k in gone]
            self._cache = fresh
        # Deletions that happened while we were not watching still reach GC.
        for pod in gone_pods:
            self._fire_delete(pod)
            self._publish(events_mod.POD_DELTA, "relist-gone", pod)
        self._last_sync_monotonic = time.monotonic()
        self._synced.set()
        return rv

    def _publish(self, topic: str, kind: str, pod: dict) -> None:
        if self._bus is None:
            return
        ns, name = self._key(pod)
        md = pod.get("metadata", {})
        self._bus.publish(topic, kind=kind, key=f"{ns}/{name}",
                          payload={"uid": md.get("uid", ""),
                                   "phase": pod.get("status", {})
                                   .get("phase", "")})

    def _fire_delete(self, pod: dict) -> None:
        if self._on_delete is not None:
            try:
                self._on_delete(pod)
            except Exception:  # noqa: BLE001
                logger.exception("delete hook failed")

    def _handle_event(self, event: dict) -> None:
        etype = event.get("type")
        pod = event.get("object", {})
        key = self._key(pod)
        if etype in ("ADDED", "MODIFIED"):
            with self._lock:
                self._cache[key] = pod
            self._publish(events_mod.POD_DELTA, etype.lower(), pod)
        elif etype == "DELETED":
            with self._lock:
                self._cache.pop(key, None)
            self._fire_delete(pod)
            self._publish(events_mod.POD_DELTA, "deleted", pod)
        elif etype == "ERROR":
            raise KubeError(f"watch error event: {pod}")

    def run(self, stop: threading.Event) -> None:
        """Blocking list+watch loop until ``stop`` (the supervised entry
        point; ``start()`` wraps it in a thread for direct use)."""
        backoff = JitteredBackoff(RETRY_MIN_S, RETRY_MAX_S)
        while not stop.is_set():
            try:
                rv = self._relist()
                backoff.reset()  # apiserver answered
                if self._bus is not None:
                    # The re-list caught us up on anything missed while
                    # the watch was down — safe to let loops stretch
                    # their safety-net sweeps again.
                    self._bus.set_degraded("sitter-watch", False)
                watch_timeout = max(1, int(self._relist_s))
                for event in self._client.watch_pods(
                    self._node, rv, timeout_s=watch_timeout
                ):
                    faults.fire("sitter.watch")
                    self._handle_event(event)
                    self._last_sync_monotonic = time.monotonic()
                    if stop.is_set():
                        return
            except Exception as e:  # noqa: BLE001
                if self._bus is not None:
                    # Watch stream died (apiserver brownout, network
                    # partition): pod deltas stop flowing, so loops
                    # must NOT keep sleeping their stretched periods.
                    # set_degraded broadcasts a BUS_WAKE that collapses
                    # every subscriber back to its base sweep period
                    # immediately — no coverage gap between push dying
                    # and poll resuming.
                    self._bus.set_degraded("sitter-watch", True)
                delay = backoff.next_delay()
                logger.warning(
                    "sitter list/watch failed (%s); retrying in %.1fs "
                    "(cache age: %s)",
                    e, delay,
                    "never-synced" if self.sync_age_s() is None
                    else f"{self.sync_age_s():.0f}s",
                )
                stop.wait(delay)

    def start(self, stop: threading.Event) -> None:
        self._thread = threading.Thread(
            target=self.run, args=(stop,), daemon=True, name="sitter"
        )
        self._thread.start()
