"""Checkpoint store: pod -> container -> device bindings, on disk.

The port's copy of ``elastic_tpu_agent/storage/store.py``: SQLite
(stdlib, ACID, one file, WAL) on a hostPath, so that bindings survive an
agent restart and ``NodeManager.restore()`` can converge them. The schema
is the agent's, all five tables (``pods``, ``bind_intents``,
``agent_state``, ``timeline``, ``timeline_meta``), and the rows are the
agent's JSON, so that a node's db written by either agent opens in the
other, bindings and lifecycle journal included.

The pod records sit behind a read-through cache that a foreign
connection's write drops; beside them the bind intent journal, the
agent-state documents and the timeline's ring-capped table. With
``batch_window_s > 0`` commits go through the group-commit batcher
(storage/batcher.py): load-bearing writes still wait for their covering
commit. With a ``bus``, store-change notifications publish after their
commit has landed (events.py).
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

from .. import events as events_mod
from .. import faults
from ..common import StripedLockSet
from ..types import PodInfo
from .batcher import GroupCommitBatcher, GroupCommitError

logger = logging.getLogger(__name__)


class StorageError(Exception):
    pass


# How long SQLite itself waits on a locked database before erroring
# (PRAGMA busy_timeout, milliseconds). A slow WAL checkpoint — or the
# node-doctor reading the db file while a bind commits — must not fail
# the bind.
BUSY_TIMEOUT_MS = 5000
# Belt and braces on top of busy_timeout: one application-level retry
# for transient "database is locked" errors before the write becomes a
# StorageError.
_LOCKED_RETRY_DELAY_S = 0.05

# sqlite3's per-connection compiled-statement cache is keyed by the SQL
# text; the bind checkpoint/mutate path runs the same handful of
# statements thousands of times per churn burst, so the hot SQL lives
# here as module constants (one string object each — guaranteed cache
# hits) and the connection's cache is sized so cold diagnostics queries
# can never evict the hot set.
_STMT_CACHE_SIZE = 256
_SQL_SAVE_POD = (
    "INSERT INTO pods(key, value) VALUES(?, ?) "
    "ON CONFLICT(key) DO UPDATE SET value=excluded.value"
)
_SQL_DELETE_POD = "DELETE FROM pods WHERE key=?"
_SQL_INSERT_INTENT = (
    "INSERT INTO bind_intents"
    "(pod_key, container, resource, hash, payload, "
    "created_ts) VALUES(?, ?, ?, ?, ?, ?)"
)
_SQL_DELETE_INTENT = "DELETE FROM bind_intents WHERE id=?"
_SQL_UPSERT_STATE = (
    "INSERT INTO agent_state(key, value, updated_ts) "
    "VALUES(?, ?, ?) ON CONFLICT(key) DO UPDATE SET "
    "value=excluded.value, updated_ts=excluded.updated_ts"
)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS pods (
    key   TEXT PRIMARY KEY,   -- "namespace/name"
    value TEXT NOT NULL       -- PodInfo JSON
);
"""

# Write-ahead bind intent journal (reconciler.py). A bind writes an
# intent row BEFORE its first side effect (virtual-node creation) and
# removes it only after the allocation record has been checkpointed —
# the pods-table record IS the commit marker, so a surviving journal
# row means "this bind never (provably) completed": the reconciler
# replays or rolls it back at the next boot/tick. Kept in the same
# SQLite file so the intent write and the checkpoint share one durable
# store (one fsync domain, one thing to hostPath-mount).
_JOURNAL_SCHEMA = """
CREATE TABLE IF NOT EXISTS bind_intents (
    id         INTEGER PRIMARY KEY AUTOINCREMENT,
    pod_key    TEXT NOT NULL,    -- "namespace/name"
    container  TEXT NOT NULL,
    resource   TEXT NOT NULL,
    hash       TEXT NOT NULL,    -- device-set hash the bind will commit
    payload    TEXT NOT NULL,    -- JSON: device_ids/chip_indexes/planned_link_ids
    created_ts REAL NOT NULL     -- wall clock, for open-intent age display
);
"""

# Durable agent-lifecycle state (drain.py journals its state machine
# here, same crash-consistency discipline as bind intents: the row is
# written BEFORE the side effects of a transition, so an agent killed
# mid-drain resumes the drain — cordon, deadline and all — on restart).
_STATE_SCHEMA = """
CREATE TABLE IF NOT EXISTS agent_state (
    key        TEXT PRIMARY KEY,
    value      TEXT NOT NULL,    -- JSON
    updated_ts REAL NOT NULL
);
"""

# Append-only lifecycle event journal (timeline.py): every state
# transition the agent makes — bind phases, reconciler repairs, drain
# transitions, slice reforms, health/cordon flips, supervisor restarts
# — lands here as one row, ring-capped so churn cannot grow the db
# without bound. AUTOINCREMENT matters: seq numbers stay monotonic per
# agent across the ring trim AND across restarts (sqlite never reuses a
# rowid from sqlite_sequence), so per-node causal order survives both.
# The eviction counter lives in timeline_meta: "how many events has the
# ring dropped" must itself be durable, or a bounded table under churn
# would be indistinguishable from a quiet one.
_TIMELINE_SCHEMA = """
CREATE TABLE IF NOT EXISTS timeline (
    seq   INTEGER PRIMARY KEY AUTOINCREMENT,
    ts    REAL NOT NULL,        -- wall clock at emit
    kind  TEXT NOT NULL,        -- event kind (timeline.py constants)
    keys  TEXT NOT NULL,        -- JSON join keys (pod/slice/chips/trace/node)
    attrs TEXT NOT NULL         -- JSON event detail
);
CREATE TABLE IF NOT EXISTS timeline_meta (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""


class Storage:
    """Thread-safe persistent map of pod key -> PodInfo.

    Interface parity with the reference Storage (storage.go:15-22):
    save / load / load_or_create / delete / for_each / close.
    """

    def __init__(self, path: str, batch_window_s: float = 0.0,
                 bus=None) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._path = path
        self._lock = threading.RLock()
        # Optional events.EventBus: store-change notifications (bind
        # commits on STORE_BIND, intent open/close on STORE_INTENT,
        # agent_state writes on STORE_STATE). Notes accumulate under
        # _lock at statement time and publish only AFTER the covering
        # commit lands — inline for unbatched commits, from the
        # group-commit batcher's flush path under batching — so a
        # subscriber never hears about a write that later rolls back.
        # Notifications are delivery HINTS for event-driven loops, not
        # a replication log: consumers re-verify against the store.
        self._bus = bus
        self._pending_notes: list = []
        # Per-key striping for composite read-modify-writes (mutate()):
        # the sqlite connection itself stays serialized under self._lock,
        # but two RMWs for DIFFERENT pods never wait on each other's
        # load->save window.
        self._key_locks = StripedLockSet(64)
        # Read-through record cache: pod key -> parsed PodInfo snapshot
        # (None = the stored row fails to parse). Once a full scan has
        # populated it, items()/for_each/corrupt_keys serve from memory —
        # GC sweeps, health fan-outs and the sampler join stop re-parsing
        # every row each tick. Our own writes keep it coherent; writes
        # from OTHER connections (node-doctor against the live db) are
        # detected via PRAGMA data_version, which sqlite bumps only for
        # foreign modifications, and drop the cache wholesale.
        self._cache: dict = {}
        self._cache_complete = False
        self._data_version: Optional[int] = None
        # Intent ids with a LIVE bind thread in THIS process between
        # journal-write and commit. The reconciler must never roll back
        # an intent that is merely slow (sqlite busy retries, a stalled
        # hostPath, stripe queueing in a rebind burst) rather than
        # crashed: membership here is exact — the bind's finally removes
        # the id on every exit including BaseException, and a real
        # process death takes the set with it, leaving exactly the
        # orphaned rows recovery exists for.
        self._inflight_intents: set = set()
        try:
            self._db = sqlite3.connect(
                path, check_same_thread=False,
                cached_statements=_STMT_CACHE_SIZE,
            )
            self._db.execute("PRAGMA journal_mode=WAL")
            self._db.execute("PRAGMA synchronous=NORMAL")
            self._db.execute(f"PRAGMA busy_timeout={BUSY_TIMEOUT_MS}")
            self._db.execute(_SCHEMA)
            self._db.execute(_JOURNAL_SCHEMA)
            self._db.execute(_STATE_SCHEMA)
            self._db.executescript(_TIMELINE_SCHEMA)
            self._db.commit()
        except sqlite3.Error as e:
            raise StorageError(f"open {path}: {e}") from e
        # -- group-commit write batching (storage/batcher.py) -------------
        # 0 = off (every write commits itself, the historical shape).
        # >0 = statements still execute inline under the lock (reads on
        # this connection stay read-your-writes), but the COMMIT is
        # deferred to one flusher commit per window: load-bearing writes
        # wait for their covering commit (durability unchanged, fsyncs
        # amortized across concurrent writers), non-load-bearing ones
        # (timeline events, intent-commit row drops) ride along free.
        self.commits_total = 0   # commits this connection actually paid
        self.writes_total = 0    # logical write transactions requested
        self._batcher: Optional[GroupCommitBatcher] = None
        if batch_window_s and batch_window_s > 0:
            self._batcher = GroupCommitBatcher(
                self._batch_commit, self._batch_rollback,
                window_s=batch_window_s,
                name=f"storage:{os.path.basename(path)}",
                # The statement lock: the batcher's failure path must
                # exclude writers while it decides which generations a
                # rollback took with it (RLock, so the rollback callback
                # may re-take it).
                lock=self._lock,
                on_commit=self._publish_batch_notes,
            )

    # -- group-commit plumbing (flusher-thread side) --------------------------

    def _batch_commit(self) -> None:
        """One group commit covering every statement executed since the
        last flush; retried once on a transient cross-connection lock."""
        with self._lock:
            for attempt in (1, 2):
                try:
                    self._db.commit()
                    self.commits_total += 1
                    return
                except sqlite3.Error as e:
                    if not (self._is_transient_lock(e) and attempt == 1):
                        raise
                time.sleep(_LOCKED_RETRY_DELAY_S)

    def _batch_rollback(self) -> None:
        """A failed group commit rolls the whole open transaction back;
        in-memory views that may now hold rolled-back state are dropped
        (sync waiters get their error from the batcher)."""
        with self._lock:
            try:
                self._db.rollback()
            except sqlite3.Error:
                pass
            self._cache = {}
            self._cache_complete = False
            self._timeline_rows_cache = None
            self._timeline_cap_stored = None
            # Notes for statements that just rolled back must never
            # publish — the events would describe state that does not
            # exist on disk.
            self._pending_notes = []

    # -- store-change notifications (events.EventBus) -------------------------

    def _note_locked(self, topic: str, kind: str, key: str) -> None:
        """(lock held) Queue one store-change notification for the
        commit that will cover the statement just executed."""
        if self._bus is not None:
            self._pending_notes.append((topic, kind, key))

    def _publish_notes_locked(self) -> None:
        """(lock held) Publish+clear pending notes — the unbatched
        post-commit path (publish only fans out to subscriber queues;
        it cannot re-enter storage)."""
        if not self._pending_notes:
            return
        notes, self._pending_notes = self._pending_notes, []
        for topic, kind, key in notes:
            self._bus.publish(topic, kind=kind, key=key)

    def _publish_batch_notes(self) -> None:
        """Group-commit flush path (batcher ``on_commit``, flusher
        thread): everything the landed commit covered publishes in one
        burst, outside the statement lock."""
        with self._lock:
            notes, self._pending_notes = self._pending_notes, []
        for topic, kind, key in notes:
            self._bus.publish(topic, kind=kind, key=key)

    def _commit_locked(self, sync: bool = True) -> Optional[int]:
        """(lock held) Commit this write, or hand it to the group-commit
        batcher; returns the batch generation to wait on (None when the
        commit already happened). ``sync`` marks a write whose caller
        will block on the commit — the batcher flushes those
        immediately instead of riding out the coalescing window."""
        self.writes_total += 1
        if self._batcher is None:
            self._db.commit()
            self.commits_total += 1
            self._publish_notes_locked()
            return None
        return self._batcher.mark_dirty(sync=sync)

    def _sync_wait(self, what: str, token: Optional[int]) -> None:
        """(lock NOT held) Block until a load-bearing write's covering
        group commit has landed; no-op when the write committed inline."""
        if token is None or self._batcher is None:
            return
        try:
            self._batcher.wait(token)
        except GroupCommitError as e:
            raise StorageError(f"{what}: {e}") from e

    def write_stats(self) -> dict:
        """Write-amplification accounting for the scale harness and
        /metrics: logical write transactions vs sqlite commits paid."""
        with self._lock:
            stats = {
                "batching": self._batcher is not None,
                "writes_total": self.writes_total,
                "commits_total": self.commits_total,
            }
        if self._batcher is not None:
            b = self._batcher.stats()
            stats["commits_total"] = b["commits_total"]
            stats["batch"] = b
        writes, commits = stats["writes_total"], stats["commits_total"]
        stats["writes_per_commit"] = (
            round(writes / commits, 3) if commits else None
        )
        return stats

    @staticmethod
    def _is_transient_lock(e: sqlite3.Error) -> bool:
        return isinstance(e, sqlite3.OperationalError) and (
            "database is locked" in str(e) or "database is busy" in str(e)
        )

    def _write(
        self, what: str, sql: str, params: tuple, sync: bool = True,
        note: Optional[tuple] = None,
    ) -> Optional[int]:
        """Execute (+commit, or join the group-commit batch) under the
        lock, retrying ONCE on a transient lock error (a concurrent
        writer on another connection — e.g. a node-doctor run against
        the live db — outlasting busy_timeout). Returns the batch token
        for :meth:`_sync_wait` (None when the commit already ran).
        ``note`` is a ``(topic, kind, key)`` store-change notification
        queued between execute and commit, so it publishes exactly when
        (and only if) the statement's covering commit lands."""
        for attempt in (1, 2):
            try:
                self._db.execute(sql, params)
                if note is not None:
                    self._note_locked(*note)
                return self._commit_locked(sync=sync)
            except sqlite3.Error as e:
                transient = self._is_transient_lock(e) and attempt == 1
                if self._batcher is None:
                    # Under batching the open transaction carries OTHER
                    # writers' uncommitted statements: one failed
                    # statement must not roll them back (sqlite keeps
                    # the transaction usable past a statement error).
                    try:
                        self._db.rollback()  # clear the failed statement
                    except sqlite3.Error:
                        pass
                    # Unbatched, pending notes can only be our own (any
                    # earlier write flushed its notes at commit) — drop
                    # them with the rolled-back statement.
                    self._pending_notes = []
                if not transient:
                    raise StorageError(f"{what}: {e}") from e
                logger.warning(
                    "%s hit %s; retrying once after %.0fms",
                    what, e, _LOCKED_RETRY_DELAY_S * 1000,
                )
                time.sleep(_LOCKED_RETRY_DELAY_S)
        return None  # pragma: no cover - loop returns or raises

    # Exceptions meaning "this stored value does not parse as a PodInfo".
    _CORRUPT = (json.JSONDecodeError, KeyError, TypeError, AttributeError)

    # -- record cache ---------------------------------------------------------

    def _check_foreign_writes(self) -> None:
        """(lock held) Drop the cache when another connection modified the
        db file since we last looked. PRAGMA data_version is unchanged by
        this connection's own writes, so the cache survives the agent's
        steady-state write traffic and invalidates exactly when an outside
        writer (e.g. a doctor run) touches the file."""
        try:
            dv = self._db.execute("PRAGMA data_version").fetchone()[0]
        except sqlite3.Error:
            # Can't tell — stay safe and drop the cache.
            self._cache = {}
            self._cache_complete = False
            return
        if dv != self._data_version:
            if self._data_version is not None:
                self._cache = {}
                self._cache_complete = False
            self._data_version = dv

    # -- CRUD ----------------------------------------------------------------

    def _save_locked(self, pod: PodInfo) -> Optional[int]:
        """(lock held) Execute the save; returns the batch token. The
        caller MUST release the lock before waiting on the token — a
        sync wait under the lock deadlocks the group-commit flusher."""
        value = pod.to_json()
        self._check_foreign_writes()
        token = self._write(
            f"save {pod.key}",
            _SQL_SAVE_POD,
            (pod.key, value),
            note=(events_mod.STORE_BIND, "save", pod.key),
        )
        # Cache a snapshot parsed back from the persisted JSON — never
        # the caller's object, which the caller may keep mutating.
        try:
            self._cache[pod.key] = PodInfo.from_json(value)
        except self._CORRUPT:  # pragma: no cover - to_json round-trips
            self._cache.pop(pod.key, None)
            self._cache_complete = False
        return token

    def save(self, pod: PodInfo) -> None:
        faults.fire("storage.save")
        with self._lock:
            token = self._save_locked(pod)
        # The checkpoint is the bind's durable commit marker: block until
        # the covering group commit lands (outside the lock, so the
        # flusher can take it).
        self._sync_wait(f"save {pod.key}", token)

    def load(self, namespace: str, name: str) -> Optional[PodInfo]:
        """Return the stored PodInfo, or None when absent (reference returns
        a not-found error; None is the idiomatic Python shape)."""
        with self._lock:
            try:
                row = self._db.execute(
                    "SELECT value FROM pods WHERE key=?",
                    (f"{namespace}/{name}",),
                ).fetchone()
            except sqlite3.Error as e:
                raise StorageError(f"load {namespace}/{name}: {e}") from e
        if row is None:
            return None
        try:
            return PodInfo.from_json(row[0])
        except self._CORRUPT as e:
            raise StorageError(
                f"corrupt record for {namespace}/{name}: {e}"
            ) from e

    def load_or_create(self, namespace: str, name: str) -> PodInfo:
        token = None
        with self._lock:
            existing = self.load(namespace, name)
            if existing is not None:
                return existing
            pod = PodInfo(namespace=namespace, name=name)
            faults.fire("storage.save")
            token = self._save_locked(pod)
        # Wait OUTSIDE the lock (see _save_locked): holding it here
        # would block the flusher this wait depends on.
        self._sync_wait(f"save {pod.key}", token)
        return pod

    def mutate(self, namespace: str, name: str, fn) -> PodInfo:
        """Atomic per-key read-modify-write: load-or-create the record,
        apply ``fn(info)``, save. Two mutate() calls for the same pod
        serialize on a striped per-key lock (never on each other's SQL
        alone, which would lose one update); mutations of UNRELATED pods
        proceed in parallel up to the sqlite connection itself."""
        with self._key_locks.acquire(f"{namespace}/{name}"):
            info = self.load_or_create(namespace, name)
            fn(info)
            self.save(info)
            return info

    def delete(self, namespace: str, name: str) -> None:
        faults.fire("storage.delete")
        with self._lock:
            self._check_foreign_writes()
            token = self._write(
                f"delete {namespace}/{name}",
                _SQL_DELETE_POD,
                (f"{namespace}/{name}",),
                note=(events_mod.STORE_BIND, "delete",
                      f"{namespace}/{name}"),
            )
            self._cache.pop(f"{namespace}/{name}", None)
        self._sync_wait(f"delete {namespace}/{name}", token)

    def count(self) -> int:
        """O(1)-per-bind record count — the gauge-update path must not
        deserialize every record just to count them.

        Once the record cache is warm this counts parseable records
        exactly like the pre-cache ``items()`` accounting did (corrupt
        rows excluded); before the first full scan it falls back to SQL
        COUNT(*), which includes a corrupt row until a scanner (GC,
        sampler — seconds after boot) warms the cache."""
        with self._lock:
            self._check_foreign_writes()
            if self._cache_complete:
                return sum(
                    1 for v in self._cache.values() if v is not None
                )
            try:
                return self._db.execute(
                    "SELECT COUNT(*) FROM pods"
                ).fetchone()[0]
            except sqlite3.Error as e:
                raise StorageError(f"count: {e}") from e

    # -- bind intent journal (write-ahead log for the bind transaction) -------

    def journal_intent(
        self,
        pod_key: str,
        container: str,
        resource: str,
        alloc_hash: str,
        payload: dict,
    ) -> int:
        """Record a bind intent BEFORE the bind's first side effect;
        returns the intent id the bind later commits. The payload must
        name everything recovery needs to undo or replay the bind
        (device ids, chip indexes, planned virtual-node link ids)."""
        faults.fire("storage.journal")
        value = json.dumps(payload, sort_keys=True)
        with self._lock:
            for attempt in (1, 2):
                try:
                    cur = self._db.execute(
                        _SQL_INSERT_INTENT,
                        (pod_key, container, resource, alloc_hash, value,
                         time.time()),
                    )
                    self._note_locked(events_mod.STORE_INTENT, "open",
                                      str(cur.lastrowid))
                    token = self._commit_locked()
                    intent_id = cur.lastrowid
                    self._inflight_intents.add(intent_id)
                    break
                except sqlite3.Error as e:
                    transient = self._is_transient_lock(e) and attempt == 1
                    if self._batcher is None:
                        try:
                            self._db.rollback()
                        except sqlite3.Error:
                            pass
                        self._pending_notes = []
                    if not transient:
                        raise StorageError(
                            f"journal intent {pod_key}/{container}: {e}"
                        ) from e
                    time.sleep(_LOCKED_RETRY_DELAY_S)
            else:  # pragma: no cover - loop breaks or raises
                raise StorageError(
                    f"journal intent {pod_key}/{container}: retries "
                    "exhausted"
                )
        # The intent must be DURABLE before the bind's first side effect
        # (that is its whole point): wait out the covering group commit.
        self._sync_wait(f"journal intent {pod_key}/{container}", token)
        return intent_id

    def journal_commit(self, intent_id: int) -> None:
        """Mark a bind intent committed. The checkpointed allocation
        record (pods table) is the durable commit marker, so committing
        an intent simply removes its row — an intent that survives a
        crash is, by construction, one whose bind never provably
        finished."""
        # Deliberately NOT sync under batching: the checkpointed pods-
        # table record is the durable commit marker, so a crash that
        # loses this row drop merely leaves an open intent whose record
        # exists — the reconciler's intent_committed repair class
        # resolves it (the bind.post_checkpoint crash window that has
        # always existed, now a few ms wider).
        with self._lock:
            self._write(
                f"journal commit {intent_id}",
                _SQL_DELETE_INTENT,
                (intent_id,),
                sync=False,
                note=(events_mod.STORE_INTENT, "close", str(intent_id)),
            )
            self._inflight_intents.discard(intent_id)

    # A rolled-back intent leaves the journal the same way a committed
    # one does; the distinct name keeps call sites self-describing.
    journal_remove = journal_commit

    def intent_done(self, intent_id: int) -> None:
        """Drop the in-process in-flight marker WITHOUT touching the
        journal row — the bind path's finally, so a thread that dies on
        an uncaught exception stops shielding its intent from recovery
        (the row itself survives for the reconciler)."""
        with self._lock:
            self._inflight_intents.discard(intent_id)

    def intent_inflight(self, intent_id: int) -> bool:
        """True while a live bind thread in this process owns the
        intent; the reconciler must not resolve such a row no matter
        how slow the bind is going."""
        with self._lock:
            return intent_id in self._inflight_intents

    def intent_open(self, intent_id: int) -> bool:
        """True while the intent row still exists (reconciler re-checks
        under the owner's bind stripe before rolling an intent back)."""
        with self._lock:
            try:
                row = self._db.execute(
                    "SELECT 1 FROM bind_intents WHERE id=?", (intent_id,)
                ).fetchone()
            except sqlite3.Error as e:
                raise StorageError(f"intent_open {intent_id}: {e}") from e
        return row is not None

    def open_intents(self) -> list:
        """All uncommitted bind intents, oldest first, with wall-clock
        age — consumed by the reconciler, /debug/allocations and the
        node-doctor bundle (a stuck intent must be diagnosable from a
        bundle alone)."""
        with self._lock:
            try:
                rows = self._db.execute(
                    "SELECT id, pod_key, container, resource, hash, "
                    "payload, created_ts FROM bind_intents ORDER BY id"
                ).fetchall()
            except sqlite3.Error as e:
                raise StorageError(f"open_intents: {e}") from e
        now = time.time()
        out = []
        for row in rows:
            try:
                payload = json.loads(row[5])
            except ValueError:
                payload = {}
            out.append({
                "id": row[0],
                "pod_key": row[1],
                "container": row[2],
                "resource": row[3],
                "hash": row[4],
                "payload": payload,
                "created_ts": row[6],
                "age_s": round(max(0.0, now - row[6]), 3),
            })
        return out

    def open_intents_brief(self) -> list:
        """open_intents() projected to the public diagnostics shape
        (``{id,pod,container,resource,hash,age_s}``) shared by the
        reconciler's status(), /debug/allocations and the node-doctor
        bundle — one place to evolve the field set, validated by
        sampler.validate_bundle."""
        return [
            {
                "id": i["id"],
                "pod": i["pod_key"],
                "container": i["container"],
                "resource": i["resource"],
                "hash": i["hash"],
                "age_s": i["age_s"],
            }
            for i in self.open_intents()
        ]

    # -- durable agent state (drain lifecycle journal) ------------------------

    def save_state(self, key: str, value: dict) -> None:
        """Persist one JSON state document under ``key`` (upsert).
        Written BEFORE the side effects of the transition it describes —
        the drain orchestrator's crash-consistency contract."""
        faults.fire("storage.state")
        with self._lock:
            token = self._write(
                f"save_state {key}",
                _SQL_UPSERT_STATE,
                (key, json.dumps(value, sort_keys=True), time.time()),
                note=(events_mod.STORE_STATE, "save", key),
            )
        # Lifecycle journals are written BEFORE their side effects run —
        # that ordering only means something if the row is durable first.
        self._sync_wait(f"save_state {key}", token)

    def load_state(self, key: str) -> Optional[dict]:
        """The stored state document, or None when absent/corrupt (a
        corrupt row is logged and treated as absent — lifecycle state is
        always safely re-derivable from a fresh start)."""
        with self._lock:
            try:
                row = self._db.execute(
                    "SELECT value FROM agent_state WHERE key=?", (key,)
                ).fetchone()
            except sqlite3.Error as e:
                raise StorageError(f"load_state {key}: {e}") from e
        if row is None:
            return None
        try:
            value = json.loads(row[0])
        except ValueError:
            logger.warning("corrupt agent_state row %r; treating as absent",
                           key)
            return None
        return value if isinstance(value, dict) else None

    def delete_state(self, key: str) -> None:
        with self._lock:
            token = self._write(
                f"delete_state {key}",
                "DELETE FROM agent_state WHERE key=?",
                (key,),
                note=(events_mod.STORE_STATE, "delete", key),
            )
        self._sync_wait(f"delete_state {key}", token)

    # -- lifecycle timeline journal (timeline.py) ------------------------------

    _TIMELINE_EVICTED_KEY = "timeline_evicted_total"
    _TIMELINE_CAP_KEY = "timeline_cap"
    # In-memory row count for the timeline ring (None = recompute from
    # SQL on next use). Every bind emits events, so the append path
    # must not pay a COUNT(*) b-tree scan per event; all timeline
    # writes go through this connection, so delta-tracking under
    # self._lock stays exact. Any sqlite error resets it to None.
    _timeline_rows_cache: Optional[int] = None
    # Last cap value persisted into timeline_meta (None = not yet
    # written this process). The cap is a process argument, but the
    # offline reader (node-doctor against a dead agent's db) must
    # report the cap the agent actually RAN with, not a compiled-in
    # default — so every append keeps the stored value current.
    _timeline_cap_stored: Optional[int] = None

    def timeline_append(
        self, ts: float, kind: str, keys: dict, attrs: dict, cap: int
    ) -> int:
        """Append one lifecycle event and trim the ring to ``cap`` rows
        (oldest first), bumping the durable eviction counter by however
        many rows the trim dropped. Returns the event's monotonic seq.
        One commit covers append + trim + counter, so a crash can never
        leave the counter disagreeing with the rows."""
        # Timeline events are non-load-bearing by contract (emit swallows
        # failures): under batching they never wait for their commit —
        # the whole churn burst's events amortize into the flusher's
        # window commits.
        keys_json = json.dumps(keys, sort_keys=True, default=str)
        attrs_json = json.dumps(attrs, sort_keys=True, default=str)
        with self._lock:
            for attempt in (1, 2):
                try:
                    if self._batcher is not None:
                        # Multi-statement append inside a SHARED open
                        # transaction: a savepoint scopes the rollback
                        # of a mid-append failure to THIS append, so a
                        # partial trim/counter update can never ride a
                        # later group commit and break the
                        # max(seq)-rows == evicted invariant — without
                        # touching other writers' pending statements.
                        self._db.execute("SAVEPOINT timeline_append")
                    cur = self._db.execute(
                        "INSERT INTO timeline(ts, kind, keys, attrs) "
                        "VALUES(?, ?, ?, ?)",
                        (ts, kind, keys_json, attrs_json),
                    )
                    seq = cur.lastrowid
                    if self._timeline_cap_stored != cap:
                        self._db.execute(
                            "INSERT INTO timeline_meta(key, value) "
                            "VALUES(?, ?) ON CONFLICT(key) DO UPDATE "
                            "SET value=excluded.value",
                            (self._TIMELINE_CAP_KEY, str(cap)),
                        )
                        self._timeline_cap_stored = cap
                    if self._timeline_rows_cache is None:
                        self._timeline_rows_cache = self._db.execute(
                            "SELECT COUNT(*) FROM timeline"
                        ).fetchone()[0]
                    else:
                        self._timeline_rows_cache += 1
                    excess = self._timeline_rows_cache - max(1, cap)
                    if excess > 0:
                        self._db.execute(
                            "DELETE FROM timeline WHERE seq IN ("
                            "SELECT seq FROM timeline ORDER BY seq "
                            "LIMIT ?)",
                            (excess,),
                        )
                        self._db.execute(
                            "INSERT INTO timeline_meta(key, value) "
                            "VALUES(?, ?) ON CONFLICT(key) DO UPDATE SET "
                            "value = CAST(value AS INTEGER) + "
                            "excluded.value",
                            (self._TIMELINE_EVICTED_KEY, str(excess)),
                        )
                        self._timeline_rows_cache -= excess
                    if self._batcher is not None:
                        self._db.execute("RELEASE timeline_append")
                    self._commit_locked(sync=False)
                    return seq
                except sqlite3.Error as e:
                    self._timeline_rows_cache = None
                    self._timeline_cap_stored = None  # write rolled back
                    transient = self._is_transient_lock(e) and attempt == 1
                    if self._batcher is None:
                        try:
                            self._db.rollback()
                        except sqlite3.Error:
                            pass
                    else:
                        # Scoped undo: only this append's statements.
                        try:
                            self._db.execute(
                                "ROLLBACK TO timeline_append"
                            )
                            self._db.execute("RELEASE timeline_append")
                        except sqlite3.Error:
                            pass
                    if not transient:
                        raise StorageError(f"timeline append: {e}") from e
                    time.sleep(_LOCKED_RETRY_DELAY_S)
        raise StorageError(
            "timeline append: retries exhausted"
        )  # pragma: no cover - loop returns

    def timeline_rows(
        self,
        since_seq: Optional[int] = None,
        since_ts: Optional[float] = None,
        limit: Optional[int] = None,
    ) -> list:
        """Journaled events oldest-first (seq order = per-agent causal
        order), each ``{seq, ts, kind, keys, attrs}`` with the JSON
        columns parsed (a corrupt column parses to {} rather than
        killing the read — the journal is triage material and must
        degrade, not disappear). ``limit`` keeps the NEWEST rows."""
        sql = "SELECT seq, ts, kind, keys, attrs FROM timeline"
        where, params = [], []
        if since_seq is not None:
            where.append("seq > ?")
            params.append(since_seq)
        if since_ts is not None:
            where.append("ts >= ?")
            params.append(since_ts)
        if where:
            sql += " WHERE " + " AND ".join(where)
        sql += " ORDER BY seq"
        with self._lock:
            try:
                rows = self._db.execute(sql, tuple(params)).fetchall()
            except sqlite3.Error as e:
                raise StorageError(f"timeline read: {e}") from e
        if limit is not None and limit >= 0:
            rows = rows[-limit:] if limit else []
        out = []
        for seq, ts, kind, keys_json, attrs_json in rows:
            try:
                keys = json.loads(keys_json)
            except ValueError:
                keys = {}
            try:
                attrs = json.loads(attrs_json)
            except ValueError:
                attrs = {}
            out.append({
                "seq": seq, "ts": ts, "kind": kind,
                "keys": keys if isinstance(keys, dict) else {},
                "attrs": attrs if isinstance(attrs, dict) else {},
            })
        return out

    def timeline_count(self) -> int:
        with self._lock:
            if self._timeline_rows_cache is not None:
                return self._timeline_rows_cache
            try:
                count = self._db.execute(
                    "SELECT COUNT(*) FROM timeline"
                ).fetchone()[0]
            except sqlite3.Error as e:
                raise StorageError(f"timeline count: {e}") from e
            self._timeline_rows_cache = count
            return count

    def timeline_meta_value(self, key: str) -> Optional[str]:
        """One timeline_meta value, or None when absent."""
        with self._lock:
            try:
                row = self._db.execute(
                    "SELECT value FROM timeline_meta WHERE key=?",
                    (key,),
                ).fetchone()
            except sqlite3.Error as e:
                raise StorageError(f"timeline meta read: {e}") from e
        return None if row is None else row[0]

    def timeline_set_meta(self, key: str, value: str) -> None:
        """Upsert one timeline_meta value — the never-evicted side
        channel for journal facts that must outlive the ring trim (the
        boot identity the doctor bundle stamps)."""
        with self._lock:
            self._write(
                f"timeline meta {key}",
                "INSERT INTO timeline_meta(key, value) VALUES(?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (key, value),
                sync=False,  # journal meta: observability, like the ring
            )

    def _timeline_meta_int(self, key: str) -> Optional[int]:
        value = self.timeline_meta_value(key)
        if value is None:
            return None
        try:
            return int(value)
        except ValueError:
            return None

    def timeline_evicted_total(self) -> int:
        """Durable count of events the ring cap has dropped (0 when the
        ring never overflowed)."""
        value = self._timeline_meta_int(self._TIMELINE_EVICTED_KEY)
        return 0 if value is None else value

    def timeline_cap_stored(self) -> Optional[int]:
        """The ring cap the WRITING agent last appended under — what an
        offline reader must report instead of its own default (None
        when no event was ever journaled)."""
        return self._timeline_meta_int(self._TIMELINE_CAP_KEY)

    def for_each(self, fn: Callable[[PodInfo], None]) -> None:
        """Invoke fn on a snapshot of every stored PodInfo.

        Snapshot first so fn may call save/delete without deadlocking or
        invalidating the cursor (the reference iterates inside one Bolt
        transaction and therefore could not; our GC deletes during
        iteration). Corrupt records are logged and skipped — GC must keep
        making progress past one bad row; use load() for loud point reads.
        """
        for _, pod in self.items():
            fn(pod)

    def _rows(self) -> Iterator[Tuple[str, Optional[PodInfo]]]:
        """Snapshot all rows; parse each to PodInfo or None when corrupt.

        Served from the read-through cache once a full scan has warmed it
        (and no foreign connection has written since). The yielded
        PodInfo objects are shared snapshots: callers may read them or
        re-save a fresh load(), but must not mutate them in place."""
        with self._lock:
            self._check_foreign_writes()
            if self._cache_complete:
                snapshot = list(self._cache.items())
            else:
                try:
                    rows = self._db.execute(
                        "SELECT key, value FROM pods"
                    ).fetchall()
                except sqlite3.Error as e:
                    raise StorageError(f"scan: {e}") from e
                snapshot = []
                for key, value in rows:
                    try:
                        snapshot.append((key, PodInfo.from_json(value)))
                    except self._CORRUPT:
                        snapshot.append((key, None))
                # Parsing ran under the lock, so no save/delete raced the
                # rebuild: installing the parsed rows is race-free.
                self._cache = dict(snapshot)
                self._cache_complete = True
        # Lock released before yielding: callers iterate (and may call
        # save/delete) without holding the storage lock hostage.
        yield from snapshot

    def items(self) -> Iterator[Tuple[str, PodInfo]]:
        for key, pod in self._rows():
            if pod is None:
                logger.warning("skipping corrupt storage record %r", key)
            else:
                yield key, pod

    def corrupt_keys(self) -> list:
        """Keys whose records fail to parse (for Restore() reporting)."""
        return [key for key, pod in self._rows() if pod is None]

    def close(self) -> None:
        if self._batcher is not None:
            # Flush-then-stop: pending batched writes (timeline tails,
            # intent-commit drops) land before the connection closes.
            self._batcher.stop()
        with self._lock:
            self._db.close()

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "Storage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
