"""Shared async fire-and-forget sink for observability writers.

The port's copy of ``elastic_tpu_agent/async_sink.py``. Both
apiserver-facing observability paths (ElasticTPU CRD publication, k8s
Event emission) must stay off the bind path, must never raise into
callers, and must self-disable after consecutive failures so that a
missing CRD or denied RBAC cannot spam the apiserver forever. This worker
implements that contract once.

Flow control:

- the worker drains in BATCHES (everything queued when it wakes) and
  writes for the same coalescing ``key`` collapse to the newest one; each
  superseded op is counted in ``merged``;
- an optional ``flush_window_s`` makes the worker LINGER after waking so
  that ops submitted close together coalesce before the drain (a bind's
  Event, CRD create and CRD status land in one window);
- the queue is BOUNDED: past ``max_queue`` the oldest entry is dropped
  (newer state wins) and counted in ``dropped``;
- failures back off on ONE shared jittered clock: a failed flush bumps
  the streak once, re-queues the unwritten ops and sleeps before
  retrying; the sink disables after ``max_failures`` consecutive failed
  flushes, and an op that fails ``max_failures`` times on its own is
  dropped rather than blocking the queue;
- ``stop()`` DRAINS: everything submitted before the call is written (or
  dropped by the bound) before the worker exits.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

from . import faults
from .common import JitteredBackoff

logger = logging.getLogger(__name__)

MAX_CONSECUTIVE_FAILURES = 5
DEFAULT_MAX_QUEUE = 4096
# Shared backoff clock for failed flush attempts (jittered exponential;
# common.JitteredBackoff): min keeps tests and transient blips quick,
# max keeps a dead apiserver from being polled hot.
DEFAULT_BACKOFF_MIN_S = 0.2
DEFAULT_BACKOFF_MAX_S = 15.0


def drop_hook(metrics) -> Optional[Callable[[], None]]:
    """The on_drop callback for a metrics object carrying the shared
    elastic_tpu_observability_dropped_total counter (one place, so every
    AsyncSink consumer wires the metric identically)."""
    if metrics is not None and hasattr(metrics, "observability_dropped"):
        return metrics.observability_dropped.inc
    return None


def register_sink_metrics(sink: "AsyncSink", metrics) -> None:
    """Export a sink's queue depth / failure streak / disabled flag as
    labeled gauges (metrics.AgentMetrics.register_sink) so the
    self-disabling observability paths are themselves observable. One
    place, same rationale as drop_hook."""
    if metrics is not None and hasattr(metrics, "register_sink"):
        try:
            metrics.register_sink(sink)
        except Exception:  # noqa: BLE001 - metrics must not break sinks
            logger.exception("sink metric registration failed for %s",
                             sink.name)


class AsyncSink:
    """Single worker thread draining a bounded, coalescing op queue;
    self-disables after ``max_failures`` consecutive errors."""

    def __init__(
        self,
        name: str,
        max_failures: int = MAX_CONSECUTIVE_FAILURES,
        max_queue: int = DEFAULT_MAX_QUEUE,
        on_drop: Optional[Callable[[], None]] = None,
        flush_window_s: float = 0.0,
        backoff_min_s: float = DEFAULT_BACKOFF_MIN_S,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
    ) -> None:
        self._name = name
        self._max_failures = max_failures
        self._max_queue = max_queue
        self._on_drop = on_drop
        # Coalescing window: after waking with work, linger this long so
        # ops submitted close together batch/dedup into one drain
        # (0 = drain immediately, the historical shape).
        self._flush_window_s = max(0.0, flush_window_s)
        # ONE backoff clock for the whole flush: a dead apiserver costs
        # one failed attempt + one (growing) sleep per cycle, not one
        # hot failure per queued op.
        self._backoff = JitteredBackoff(backoff_min_s, backoff_max_s)
        # Invoked once per successfully drained op (request-amplification
        # accounting; metrics.AgentMetrics.register_sink points it at the
        # per-sink elastic_tpu_sink_writes_total counter). Note ops are
        # thunks: a batched op (boot inventory publish) counts once.
        self.on_write: Optional[Callable[[], None]] = None
        self._writes = 0
        # Insertion-ordered op store: coalescing keys map to their newest
        # op in O(1); un-keyed ops get a unique sequence number. Dict
        # order gives O(1) drop-oldest and preserves submit order.
        self._items: "dict[object, Callable]" = {}
        self._seq = 0
        self._failures = 0
        self._disabled = False
        self._stopping = False
        self._busy = False
        self._dropped = 0
        self._merged = 0
        # Per-op failure counts for the ops currently cycling through
        # failed flushes: an op that keeps failing while LATER ops would
        # succeed (a deterministic 4xx, not a dead apiserver) is dropped
        # after max_failures of its OWN failures instead of head-of-line
        # blocking the queue until the whole sink disables. Pruned on
        # success/drop and at requeue, so it only ever holds the keys of
        # currently-failing ops.
        self._op_failures: "dict[object, int]" = {}
        self._cond = threading.Condition()
        self._worker_error: Optional[BaseException] = None
        self._thread = self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._worker, daemon=True, name=self._name)
        t.start()
        return t

    @property
    def name(self) -> str:
        return self._name

    @property
    def disabled(self) -> bool:
        return self._disabled

    @property
    def dropped(self) -> int:
        """Ops discarded by the queue bound since start."""
        return self._dropped

    @property
    def merged(self) -> int:
        """Queued ops superseded by a newer same-key submission before
        they were drained (each one is an apiserver write the coalescing
        saved)."""
        return self._merged

    @property
    def writes_total(self) -> int:
        """Ops successfully drained since start (racy read — a gauge/
        introspection feed, not an invariant)."""
        return self._writes

    @property
    def queue_depth(self) -> int:
        """Ops currently queued (racy read — it feeds a gauge)."""
        return len(self._items)

    @property
    def consecutive_failures(self) -> int:
        """Current failure streak (resets on success; the sink disables
        itself at max_failures)."""
        return self._failures

    def submit(self, op: Callable, key: Optional[object] = None) -> None:
        """Enqueue a thunk; non-blocking, never raises. A non-None ``key``
        coalesces: any queued op with the same key is superseded."""
        if self._disabled:
            return
        with self._cond:
            if self._stopping:
                return
            if key is None:
                self._seq += 1
                key = ("_seq", self._seq)
            elif self._items.pop(key, None) is not None:
                # superseding moves the write to the newest position
                self._merged += 1
            if len(self._items) >= self._max_queue:
                oldest = next(iter(self._items))
                del self._items[oldest]  # drop-oldest: newer state wins
                self._dropped += 1
                if self._on_drop is not None:
                    try:
                        self._on_drop()
                    except Exception:  # noqa: BLE001
                        pass
                if self._dropped in (1, 100) or self._dropped % 1000 == 0:
                    logger.warning(
                        "%s queue full (%d): dropped %d op(s) so far",
                        self._name, self._max_queue, self._dropped,
                    )
            self._items[key] = op
            self._cond.notify_all()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until queued work has drained (tests / shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._items or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def stop(self, timeout: float = 30.0) -> None:
        """Drain-then-stop: the worker writes everything already queued,
        then exits. The timeout only guards a wedged apiserver op (the
        thread is a daemon and dies with the process in that case)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            logger.warning(
                "%s worker still draining after %.1fs; abandoning "
                "(%d op(s) may be lost)",
                self._name, timeout, len(self._items),
            )

    # -- supervision (supervisor.py) ------------------------------------------

    def run_supervised(self, stop: threading.Event) -> None:
        """Supervisor target: watch the internal worker thread; if it died
        on an uncaught exception, re-raise that error so the supervisor's
        restart/backoff/circuit-breaker accounting applies, and respawn
        the worker on the next (supervisor-driven) invocation. Returns
        cleanly on global stop or owner ``stop()`` (drain-exit)."""
        with self._cond:
            if not self._thread.is_alive() and not self._stopping:
                self._worker_error = None
                self._thread = self._spawn_worker()
        while not stop.is_set():
            self._thread.join(timeout=0.5)
            if not self._thread.is_alive():
                if self._stopping:
                    return  # drain-exit: the owner stopped this sink
                err = self._worker_error
                raise err if err is not None else RuntimeError(
                    f"{self._name} worker exited without stop"
                )

    def _worker(self) -> None:
        try:
            self._worker_body()
        except BaseException as e:  # noqa: BLE001 - recorded for supervision
            # A dead worker would silently stop draining the queue; record
            # the death so run_supervised() can surface it and respawn.
            # DieThread (fault injection) lands here too — deliberately.
            with self._cond:
                self._worker_error = e
                self._busy = False
                self._cond.notify_all()  # un-wedge flush()ers

    def _wait_until(self, end: float) -> None:
        """Sleep on the condition until ``end`` (monotonic) or stop; a
        plain sleep would ignore stop(), a single cond.wait would be cut
        short by every submit."""
        with self._cond:
            while not self._stopping:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return
                self._cond.wait(timeout=remaining)

    def _count_drop(self, n: int = 1) -> None:
        self._dropped += n
        if self._on_drop is not None:
            for _ in range(n):
                try:
                    self._on_drop()
                except Exception:  # noqa: BLE001
                    pass

    def _worker_body(self) -> None:
        while True:
            with self._cond:
                while not self._items and not self._stopping:
                    self._cond.wait()
                if not self._items:  # stopping and drained
                    self._cond.notify_all()
                    return
            # Coalescing window: linger so a burst submitted together is
            # drained together — same-key ops dedup in the queue instead
            # of each paying an apiserver write. Skipped when stopping
            # (drain fast) or disabled (nothing will be written anyway).
            if (
                self._flush_window_s > 0
                and not self._stopping and not self._disabled
            ):
                self._wait_until(time.monotonic() + self._flush_window_s)
            # Failpoint BEFORE the batch is claimed: a raise/die-thread
            # here leaves every queued op intact for the respawned worker
            # (the chaos suite asserts nothing is dropped across a worker
            # crash). Only this worker pops, so the re-lock is race-free.
            faults.fire(f"sink.{self._name}")
            with self._cond:
                batch = list(self._items.items())
                self._items = {}
                self._busy = True
            failed_at: Optional[int] = None
            error: Optional[Exception] = None
            i = 0
            while i < len(batch):
                key, op = batch[i]
                if self._disabled:
                    # claimed-after-disable: dropped like submit refuses,
                    # but COUNTED — this is where losses are largest
                    self._count_drop(len(batch) - i)
                    i = len(batch)
                    break
                try:
                    op()
                except Exception as e:  # noqa: BLE001 - must not wedge
                    fails = self._op_failures.get(key, 0) + 1
                    if fails >= self._max_failures:
                        # This op ITSELF keeps failing while the flush
                        # around it may be fine (deterministic apiserver
                        # rejection): drop it and keep draining, rather
                        # than head-of-line blocking the queue until the
                        # whole sink disables.
                        self._op_failures.pop(key, None)
                        self._count_drop()
                        logger.warning(
                            "%s op dropped after %d failed attempts "
                            "(last: %s)", self._name, fails, e,
                        )
                        i += 1
                        continue
                    self._op_failures[key] = fails
                    failed_at, error = i, e
                    break
                self._op_failures.pop(key, None)
                self._failures = 0
                self._backoff.reset()
                self._writes += 1
                cb = self.on_write
                if cb is not None:
                    try:
                        cb()
                    except Exception:  # noqa: BLE001
                        pass
                i += 1
            if failed_at is None:
                with self._cond:
                    self._busy = False
                    if not self._items:
                        self._cond.notify_all()
                continue
            # Failed flush: ONE streak bump for the whole attempt (not
            # one per queued op), the unwritten tail re-queued for the
            # retry (ops superseded by a newer same-key submission while
            # we held the batch stay superseded), and one shared backoff
            # clock before the next attempt.
            self._failures += 1
            disable = self._failures >= self._max_failures
            with self._cond:
                if disable:
                    self._disabled = True
                    # the unwritten tail dies with the sink: counted
                    self._count_drop(len(batch) - failed_at)
                    self._op_failures.clear()
                else:
                    requeue = {}
                    for key, op in batch[failed_at:]:
                        if key in self._items:
                            self._merged += 1
                        else:
                            requeue[key] = op
                    self._items = {**requeue, **self._items}
                    # failure counters only for ops still in play
                    self._op_failures = {
                        k: v for k, v in self._op_failures.items()
                        if k in self._items
                    }
                    # Re-apply the queue bound: the requeue merged with
                    # ops submitted during the flush/backoff, and the
                    # documented memory bound must hold through failure
                    # cycles too (drop-oldest, counted as ever).
                    excess = len(self._items) - self._max_queue
                    if excess > 0:
                        for old in list(self._items)[:excess]:
                            del self._items[old]
                        self._count_drop(excess)
                self._busy = False
                if not self._items:
                    self._cond.notify_all()
            if disable:
                logger.warning(
                    "%s disabled after %d consecutive failed flushes "
                    "(last: %s; %d op(s) dropped)",
                    self._name, self._failures, error,
                    len(batch) - failed_at,
                )
                continue
            delay = self._backoff.next_delay()
            logger.warning(
                "%s flush failed (%s); retrying %d queued op(s) in "
                "%.1fs (streak %d/%d)",
                self._name, error, len(batch) - failed_at, delay,
                self._failures, self._max_failures,
            )
            self._wait_until(time.monotonic() + delay)
