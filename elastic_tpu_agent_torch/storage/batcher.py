"""Group-commit write batcher: one durable COMMIT serves many writers.

The port's copy of ``elastic_tpu_agent/storage/batcher.py``. Unbatched,
every storage write pays its own ``COMMIT``: several sqlite commits a bind
(the intent journal, the checkpoint, the intent commit, timeline events).
Writers execute their statements on the shared connection as before (so
same-connection reads stay read-your-writes), then register with the
batcher instead of committing; a flusher thread commits the open
transaction once per flush window, covering every write that joined it.

Crash-consistency is a property of WHO WAITS, not of the batching:

- **sync writers** (bind checkpoints, intent journals, agent_state
  writes) block until the group commit that covers their write has
  durably landed: the bind's commit marker is still on disk before
  PreStartContainer returns.
- **async writers** (timeline events, intent-commit row drops) return at
  once and ride the next flush. Neither is load-bearing: the timeline is
  observability (emit swallows failures), and a lost intent-commit leaves
  an open intent whose checkpointed record IS the commit marker, which
  the reconciler's ``intent_committed`` repair resolves (the crash window
  ``bind.post_checkpoint`` exercises).

A failed flush rolls the whole open transaction back: every sync waiter
covered by it gets a GroupCommitError (its write did NOT land), and the
owner's rollback callback drops any caches that may hold rolled-back
state.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

from .. import faults

logger = logging.getLogger(__name__)

# How long a sync writer will wait for its covering group commit before
# giving up (the flusher runs every few ms; hitting this means the
# flusher thread is dead or the disk has wedged outright).
SYNC_WAIT_TIMEOUT_S = 30.0

# Failed-flush error records kept around for late waiters; commits are
# strictly ordered so anything older than this many generations has no
# waiter left.
_ERROR_KEEP_GENS = 64


class GroupCommitError(RuntimeError):
    """The group commit covering a sync write failed (the write rolled
    back with it) or could not be confirmed in time."""


class GroupCommitBatcher:
    """Coalesces transaction commits across writers into one flush per
    window.

    ``commit_fn`` / ``rollback_fn`` are supplied by the owning Storage
    and must take the storage lock themselves; the batcher NEVER holds
    its own condition while calling them (writers hold the storage lock
    when they call :meth:`mark_dirty`, so the inverse ordering would
    deadlock).
    """

    def __init__(
        self,
        commit_fn: Callable[[], None],
        rollback_fn: Callable[[], None],
        window_s: float,
        name: str = "storage",
        lock=None,
        on_commit: Optional[Callable[[], None]] = None,
    ) -> None:
        self._commit_fn = commit_fn
        self._rollback_fn = rollback_fn
        # Post-commit hook, called on the flusher thread AFTER a group
        # commit durably lands (and after waiters are released): the
        # owning Storage publishes its store-change notifications here,
        # so subscribers only ever hear about state that is already on
        # disk. Exceptions are contained — observability must never
        # fail a commit that already succeeded.
        self._on_commit = on_commit
        # The OWNER's statement lock (Storage._lock): writers execute
        # their statements and call mark_dirty under it. The failure
        # path must hold it too — a rollback discards EVERY uncommitted
        # statement, including ones writers executed after the flusher
        # claimed its generation, so the set of generations to fail can
        # only be decided with writers excluded.
        self._owner_lock = lock if lock is not None else threading.Lock()
        self.window_s = max(0.0005, float(window_s))
        self._name = name
        self._cond = threading.Condition()
        self._gen = 0            # generation currently accepting writes
        self._committed_gen = -1  # newest durably committed generation
        self._pending = 0        # writes in the accepting generation
        self._sync_pending = False  # a blocked waiter is in this gen
        self._errors: Dict[int, BaseException] = {}
        self._stopping = False
        # -- stats (write_stats() / the scale harness read these) ------
        self.commits_total = 0
        self.writes_total = 0
        self.sync_waits_total = 0
        self.flush_failures_total = 0
        self.max_batched_writes = 0
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True,
            name=f"{name}-group-commit",
        )
        self._thread.start()

    # -- writer side ----------------------------------------------------------

    def mark_dirty(self, sync: bool = False) -> int:
        """Register one executed-but-uncommitted write; returns the
        generation whose commit will cover it. Callers may hold the
        storage lock (the batcher takes only its own condition).

        ``sync=True`` marks a write whose caller will block in
        :meth:`wait`: the flusher commits IMMEDIATELY instead of riding
        out the window, so load-bearing writes pay ~one commit of
        latency, not the window — grouping still happens because writers
        arriving while that commit runs land in the next generation
        together, and async traffic piggybacks for free."""
        with self._cond:
            self._pending += 1
            self.writes_total += 1
            if sync:
                self._sync_pending = True
            gen = self._gen
            self._cond.notify_all()
            return gen

    def wait(self, gen: int, timeout_s: float = SYNC_WAIT_TIMEOUT_S) -> None:
        """Block until generation ``gen`` has durably committed; raises
        GroupCommitError when its flush failed (the write rolled back)
        or the flusher never confirmed it."""
        import time

        from ..tracing import get_tracer

        deadline = time.monotonic() + timeout_s
        # storage_flush_wait rides inside the bind's "checkpoint" span;
        # the latency observatory attributes it innermost-first, so the
        # durability stall shows up as storage_sync, not as mystery
        # checkpoint time. No-op (two monotonic reads) without a trace.
        with get_tracer().span("storage_flush_wait", gen=gen), self._cond:
            self.sync_waits_total += 1
            while self._committed_gen < gen and gen not in self._errors:
                if self._stopping and not self._thread.is_alive():
                    # The flusher drains everything pending before it
                    # exits; a dead flusher with our generation still
                    # unconfirmed means the write never landed.
                    raise GroupCommitError(
                        f"{self._name}: batcher stopped before "
                        f"generation {gen} committed"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GroupCommitError(
                        f"{self._name}: group commit for generation "
                        f"{gen} not confirmed within {timeout_s:.0f}s"
                    )
                self._cond.wait(timeout=min(remaining, 0.5))
            err = self._errors.get(gen)
        if err is not None:
            raise GroupCommitError(
                f"{self._name}: group commit failed; write rolled back "
                f"({err})"
            ) from err

    # -- flusher side ----------------------------------------------------------

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while self._pending == 0 and not self._stopping:
                    self._cond.wait()
                if self._stopping and self._pending == 0:
                    return
            # Window: let async traffic pile into this generation — but
            # a sync writer showing up (or already waiting) flushes NOW;
            # its caller is blocked on this commit.
            import time

            end = time.monotonic() + self.window_s
            with self._cond:
                while not self._sync_pending and not self._stopping:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            self._flush_once()

    def _flush_once(self) -> None:
        with self._cond:
            if self._pending == 0:
                return
            gen, batched = self._gen, self._pending
            self._gen += 1
            self._pending = 0
            self._sync_pending = False
        err: Optional[BaseException] = None
        try:
            # Fault seam: a failed flush here exercises
            # the whole-transaction rollback + sync-waiter error path —
            # the "disk refused the group commit" story. Arm with e.g.
            # ``storage.batch_flush=prob:0.3:7`` for a flaky disk.
            faults.fire("storage.batch_flush")
            self._commit_fn()
        except BaseException as e:  # noqa: BLE001 - surfaced to waiters
            err = e
            self._fail_flush(gen, batched, e)
            return
        with self._cond:
            self.commits_total += 1
            self.max_batched_writes = max(
                self.max_batched_writes, batched
            )
            # NOTE: the successful commit may also have covered
            # statements already executed for the NEXT generation (a
            # writer can slip in between the claim above and the
            # commit). Early durability is harmless; its waiter simply
            # waits one more flush.
            self._committed_gen = gen
            self._cond.notify_all()
        if self._on_commit is not None:
            try:
                self._on_commit()
            except Exception:  # noqa: BLE001 - never fail a landed commit
                logger.exception("%s: post-commit hook failed", self._name)

    def _fail_flush(self, gen: int, batched: int, err: BaseException) -> None:
        """A failed commit rolls back the WHOLE open transaction — not
        just generation ``gen``: writers that executed statements after
        the flusher claimed ``gen`` were assigned ``gen+1``, but their
        statements died in the same rollback. Holding the owner's
        statement lock across rollback + bookkeeping excludes writers,
        so every generation up to the CURRENT accepting one at that
        instant is failed (its waiters get the error instead of a
        silent success from a later, now-empty commit) and a fresh
        generation starts clean."""
        with self._owner_lock:
            try:
                self._rollback_fn()
            except Exception:  # noqa: BLE001 - rollback is best-effort
                logger.exception("%s: rollback after failed group commit "
                                 "also failed", self._name)
            with self._cond:
                self.flush_failures_total += 1
                failed_through = self._gen
                for g in range(gen, failed_through + 1):
                    self._errors[g] = err
                self._gen = failed_through + 1
                self._pending = 0  # those statements died in the rollback
                self._sync_pending = False
                for old in [
                    g for g in self._errors
                    if g < failed_through - _ERROR_KEEP_GENS
                ]:
                    del self._errors[old]
                logger.warning(
                    "%s: group commit of %d write(s) failed "
                    "(generations %d..%d rolled back): %s",
                    self._name, batched, gen, failed_through, err,
                )
                self._committed_gen = failed_through
                self._cond.notify_all()

    def flush(self, timeout_s: float = SYNC_WAIT_TIMEOUT_S) -> None:
        """Commit everything currently pending and wait for it (tests,
        Storage.close())."""
        with self._cond:
            if self._pending == 0:
                return
            gen = self._gen
            # Force an immediate flush: without this the flusher would
            # ride out its whole window first, stalling close() by up
            # to window_s for no one's benefit.
            self._sync_pending = True
            self._cond.notify_all()
        self.wait(gen, timeout_s=timeout_s)

    def stop(self, timeout_s: float = SYNC_WAIT_TIMEOUT_S) -> None:
        """Flush pending writes, then stop the flusher thread."""
        try:
            self.flush(timeout_s=timeout_s)
        except GroupCommitError:
            pass  # surfaced to any sync waiters already
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout_s)

    def stats(self) -> dict:
        with self._cond:
            return {
                "window_s": self.window_s,
                "commits_total": self.commits_total,
                "writes_total": self.writes_total,
                "sync_waits_total": self.sync_waits_total,
                "flush_failures_total": self.flush_failures_total,
                "max_batched_writes": self.max_batched_writes,
                "pending": self._pending,
            }
