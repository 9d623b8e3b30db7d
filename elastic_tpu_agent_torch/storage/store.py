"""Checkpoint store: pod -> container -> device bindings, on disk.

The port's copy of ``elastic_tpu_agent/storage/store.py``: SQLite
(stdlib, ACID, one file, WAL) on a hostPath, so that bindings survive an
agent restart and ``NodeManager.restore()`` can converge them. The schema
is the agent's, all five tables (``pods``, ``bind_intents``,
``agent_state``, ``timeline``, ``timeline_meta``), and the records are the
agent's JSON, so a node's db written by either agent opens in the other
and a node switched between them keeps its bindings.

Ported: the pod records (``save``/``load``/``load_or_create``/``mutate``/
``delete``/``count``/``items``/``for_each``/``corrupt_keys``, behind a
read-through cache that a foreign connection's write drops), the bind
intent journal, the agent-state documents, the retry of a transient
"database is locked" and ``close``. Every write commits itself (the
agent's ``storage_batch_window_s=0``, its default): the group-commit
batcher and the ``timeline_*`` methods come with the port's
``timeline.py``; their tables are created here so that the schema stays
the agent's.
"""

from __future__ import annotations

import json
import logging
import os
import sqlite3
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

from .. import faults
from ..common import StripedLockSet
from ..types import PodInfo

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
# statements for every bind, so the hot SQL lives here as module
# constants and the connection's cache is sized so that cold queries
# never evict them.
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

    def __init__(self, path: str) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._path = path
        self._lock = threading.RLock()
        # Per-key striping for composite read-modify-writes (mutate()):
        # the sqlite connection itself stays serialized under self._lock,
        # but two RMWs for DIFFERENT pods never wait on each other's
        # load->save window.
        self._key_locks = StripedLockSet(64)
        # Read-through record cache: pod key -> parsed PodInfo snapshot
        # (None = the stored row fails to parse). Once a full scan has
        # populated it, items()/for_each/corrupt_keys serve from memory:
        # GC sweeps and reconciler passes stop re-parsing every row. Our
        # own writes keep it coherent; writes from OTHER connections (a
        # tool on the live db, the other agent) are detected via PRAGMA
        # data_version, which sqlite bumps only for foreign
        # modifications, and drop the cache wholesale.
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

    @staticmethod
    def _is_transient_lock(e: sqlite3.Error) -> bool:
        return isinstance(e, sqlite3.OperationalError) and (
            "database is locked" in str(e) or "database is busy" in str(e)
        )

    def _write(self, what: str, sql: str, params: tuple) -> None:
        """Execute and commit under the lock, retrying ONCE on a transient
        lock error (a writer on another connection, e.g. a tool reading
        the live db, outlasting busy_timeout)."""
        for attempt in (1, 2):
            try:
                self._db.execute(sql, params)
                self._db.commit()
                return
            except sqlite3.Error as e:
                transient = self._is_transient_lock(e) and attempt == 1
                try:
                    self._db.rollback()  # clear the failed statement
                except sqlite3.Error:
                    pass
                if not transient:
                    raise StorageError(f"{what}: {e}") from e
                logger.warning(
                    "%s hit %s; retrying once after %.0fms",
                    what, e, _LOCKED_RETRY_DELAY_S * 1000,
                )
                time.sleep(_LOCKED_RETRY_DELAY_S)

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

    def _save_locked(self, pod: PodInfo) -> None:
        """(lock held) Write one record and cache a snapshot of it."""
        value = pod.to_json()
        self._check_foreign_writes()
        self._write(f"save {pod.key}", _SQL_SAVE_POD, (pod.key, value))
        # Cache a snapshot parsed back from the persisted JSON, never the
        # caller's object, which the caller may keep mutating.
        try:
            self._cache[pod.key] = PodInfo.from_json(value)
        except self._CORRUPT:  # pragma: no cover - to_json round-trips
            self._cache.pop(pod.key, None)
            self._cache_complete = False

    def save(self, pod: PodInfo) -> None:
        faults.fire("storage.save")
        with self._lock:
            self._save_locked(pod)

    def load(self, namespace: str, name: str) -> Optional[PodInfo]:
        """The stored PodInfo, or None when absent."""
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
        with self._lock:
            existing = self.load(namespace, name)
            if existing is not None:
                return existing
            pod = PodInfo(namespace=namespace, name=name)
            faults.fire("storage.save")
            self._save_locked(pod)
        return pod

    def mutate(self, namespace: str, name: str, fn) -> PodInfo:
        """Atomic per-key read-modify-write: load-or-create the record,
        apply ``fn(info)``, save. Two mutate() calls for the same pod
        serialize on a striped per-key lock; mutations of unrelated pods
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
            self._write(f"delete {namespace}/{name}", _SQL_DELETE_POD,
                        (f"{namespace}/{name}",))
            self._cache.pop(f"{namespace}/{name}", None)

    def count(self) -> int:
        """The record count without parsing every record: parseable
        records once the cache is warm (corrupt rows excluded), SQL
        COUNT(*) before the first full scan."""
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
        returns the intent id the bind later commits. The payload names
        everything recovery needs to undo or replay the bind (device ids,
        card indexes, planned virtual-node link ids)."""
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
                    self._db.commit()
                    intent_id = cur.lastrowid
                    self._inflight_intents.add(intent_id)
                    return intent_id
                except sqlite3.Error as e:
                    transient = self._is_transient_lock(e) and attempt == 1
                    try:
                        self._db.rollback()
                    except sqlite3.Error:
                        pass
                    if not transient:
                        raise StorageError(
                            f"journal intent {pod_key}/{container}: {e}"
                        ) from e
                    time.sleep(_LOCKED_RETRY_DELAY_S)
        raise StorageError(  # pragma: no cover - the loop returns or raises
            f"journal intent {pod_key}/{container}: retries exhausted")

    def journal_commit(self, intent_id: int) -> None:
        """Mark a bind intent committed. The checkpointed allocation
        record (pods table) is the durable commit marker, so committing
        an intent removes its row: an intent that survives a crash is,
        by construction, one whose bind never provably finished."""
        with self._lock:
            self._write(f"journal commit {intent_id}", _SQL_DELETE_INTENT,
                        (intent_id,))
            self._inflight_intents.discard(intent_id)

    # A rolled-back intent leaves the journal the same way a committed
    # one does; the distinct name keeps call sites self-describing.
    journal_remove = journal_commit

    def intent_done(self, intent_id: int) -> None:
        """Drop the in-process in-flight marker WITHOUT touching the
        journal row: the bind path's finally, so that a thread that dies
        on an uncaught exception stops shielding its intent from recovery
        (the row itself survives for the reconciler)."""
        with self._lock:
            self._inflight_intents.discard(intent_id)

    def intent_inflight(self, intent_id: int) -> bool:
        """True while a live bind thread in this process owns the intent;
        the reconciler must not resolve such a row however slow the bind
        is going."""
        with self._lock:
            return intent_id in self._inflight_intents

    def intent_open(self, intent_id: int) -> bool:
        """True while the intent row still exists (the reconciler
        re-checks under the owner's bind stripe before rolling an intent
        back)."""
        with self._lock:
            try:
                row = self._db.execute(
                    "SELECT 1 FROM bind_intents WHERE id=?", (intent_id,)
                ).fetchone()
            except sqlite3.Error as e:
                raise StorageError(f"intent_open {intent_id}: {e}") from e
        return row is not None

    def open_intents(self) -> list:
        """Every uncommitted bind intent, oldest first, with its
        wall-clock age."""
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
        """open_intents() projected to the diagnostics shape
        ``{id, pod, container, resource, hash, age_s}`` (the
        reconciler's status())."""
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

    # -- durable agent state --------------------------------------------------

    def save_state(self, key: str, value: dict) -> None:
        """Persist one JSON state document under ``key`` (upsert), written
        before the side effects of the transition it describes."""
        faults.fire("storage.state")
        with self._lock:
            self._write(f"save_state {key}", _SQL_UPSERT_STATE,
                        (key, json.dumps(value, sort_keys=True), time.time()))

    def load_state(self, key: str) -> Optional[dict]:
        """The stored state document, or None when absent or corrupt (a
        corrupt row is logged and treated as absent)."""
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
            self._write(f"delete_state {key}",
                        "DELETE FROM agent_state WHERE key=?", (key,))

    # -- iteration ------------------------------------------------------------

    def for_each(self, fn: Callable[[PodInfo], None]) -> None:
        """Invoke fn on a snapshot of every stored PodInfo. The snapshot
        is taken first, so fn may save or delete; corrupt records are
        logged and skipped (GC keeps making progress past one bad row;
        load() reads a point loudly)."""
        for _, pod in self.items():
            fn(pod)

    def _rows(self) -> Iterator[Tuple[str, Optional[PodInfo]]]:
        """Snapshot every row, each parsed to a PodInfo or None when
        corrupt; served from the read-through cache once a full scan has
        warmed it (and no foreign connection has written since). The
        PodInfo objects are shared snapshots: read them, never mutate
        them in place."""
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
                self._cache = dict(snapshot)
                self._cache_complete = True
        # the lock is released before yielding: callers iterate (and may
        # save or delete) without holding the storage lock
        yield from snapshot

    def items(self) -> Iterator[Tuple[str, PodInfo]]:
        for key, pod in self._rows():
            if pod is None:
                logger.warning("skipping corrupt storage record %r", key)
            else:
                yield key, pod

    def corrupt_keys(self) -> list:
        """Keys whose records fail to parse (restore's report)."""
        return [key for key, pod in self._rows() if pod is None]

    def close(self) -> None:
        with self._lock:
            self._db.close()

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "Storage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
