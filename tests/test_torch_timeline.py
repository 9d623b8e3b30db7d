"""The port's lifecycle timeline (``timeline.py``, the store's
``timeline_*`` methods) and group-commit batcher (``storage/batcher.py``)
against the agent's.

The same emits, under each package's ``ManualClock``, give the same rows
and the same answers to every query (pod, bare pod name, slice, chip,
node, trace, since, kinds, limit, causal or not); the ring cap trims the
oldest rows and counts them durably; a db written by either package reads
the same in the other's ``Timeline``. The batcher holds a sync writer
until its covering commit lands and lets an async one ride the next
flush, and a failed flush fails its waiters, in both packages alike. A
crash at each ``bind.*`` point under a 0.005 s group-commit window
restores to the agent's report, its journal tells the same story as the
agent's, and ``verify_bind_story`` finds no phantom commit or dangling
intent.
"""

import os
import shutil
import sqlite3
import tempfile
import threading
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import common as agent_common  # noqa: E402
from elastic_tpu_agent import timeline as agent_timeline  # noqa: E402
from elastic_tpu_agent.storage import Storage as AgentStorage  # noqa: E402
from elastic_tpu_agent.storage import batcher as agent_batcher  # noqa: E402
from elastic_tpu_agent.types import PodInfo as AgentPodInfo  # noqa: E402
from elastic_tpu_agent_torch import common, timeline  # noqa: E402
from elastic_tpu_agent_torch.storage import Storage, batcher  # noqa: E402
from elastic_tpu_agent_torch.types import PodInfo  # noqa: E402

from test_torch_reconciler import (  # noqa: E402
    CRASH_OUTCOME,
    FAILPOINTS,
    hash_map,
    plant_crash,
)
from torch_agent_rig import Node, port_report, to_agent  # noqa: E402

SIDES = {
    "port": (timeline, Storage, common, batcher, PodInfo),
    "agent": (agent_timeline, AgentStorage, agent_common, agent_batcher,
              AgentPodInfo),
}


def wait_until(fn, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.002)
    return fn()


@pytest.fixture
def tmp():
    root = tempfile.mkdtemp(prefix="tl", dir="/tmp")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def emit_script(tl_mod, tl, clock):
    """A node's story: a boot, two binds with their trace, a health flip
    on a bound card, a repair, a slice stamp, a slow span, a reclaim."""
    K = tl_mod
    tl.emit(K.KIND_AGENT_STARTED, version="0.1.0", boot_id="b00t")
    for pod, chips, trace in (("ns/a", [1], "t-a"), ("ns/b", [2, 3], "t-b")):
        clock.advance(1.0)
        keys = {"pod": pod, "container": "main", "hash": pod[-1] * 8,
                "chips": chips, "trace": trace}
        tl.emit(K.KIND_BIND_INTENT, keys=keys, resource="r", intent_id=1)
        clock.advance(0.5)
        tl.emit(K.KIND_BIND_COMMIT, keys=keys, resource="r", intent_id=1)
    clock.advance(2.0)
    tl.emit(K.KIND_CHIP_HEALTH, keys={"chips": [3]}, healthy=False,
            reasons={"3": "ecc"})
    tl.emit(K.KIND_RECONCILE_REPAIR, keys={"pod": "ns/b", "trace": "t-r"},
            **{"class": "restored_link", "link": "bbbb-0"})
    tl.emit(K.KIND_SLICE_FORMED, keys={"pod": "ns/c", "slice": "s1"},
            epoch=1)
    tl.emit(K.KIND_SLOW_SPAN, keys={"pod": "ns/a", "trace": "t-a"},
            span="checkpoint", duration_ms=300.0)
    clock.advance(3.0)
    tl.emit(K.KIND_POD_RECLAIMED, keys={"pod": "ns/a", "hash": "aaaaaaaa"},
            source="gc", hashes=["aaaaaaaa"])


QUERIES = [
    {}, {"pod": "ns/a"}, {"pod": "b"}, {"pod": "ns/b", "causal": False},
    {"slice_id": "s1"}, {"chip": 3}, {"chip": 1}, {"node": "node-a"},
    {"trace": "t-a"}, {"since": 1002.0}, {"kinds": ["bind_commit"]},
    {"pod": "ns/a", "limit": 2}, {"limit": 0},
]


def journal(side, root, cap=timeline.DEFAULT_CAP):
    tl_mod, store_cls, com = SIDES[side][:3]
    store = store_cls(os.path.join(root, f"{side}.db"))
    clock = com.ManualClock(1000.0)
    tl = tl_mod.Timeline(store, node_name="node-a", cap=cap, clock=clock)
    emit_script(tl_mod, tl, clock)
    out = dict(rows=store.timeline_rows(),
               queries=[tl.events(**q) for q in QUERIES])
    st = tl.status()
    out["status"] = {k: v for k, v in st.items() if k != "boot_id"}
    out["cap_stored"] = store.timeline_cap_stored()
    store.close()
    return out


def test_emits_give_the_agents_rows_and_queries(tmp):
    port = journal("port", tmp)
    assert port == journal("agent", tmp)
    assert [e["kind"] for e in port["rows"]][:3] == [
        "agent_started", "bind_intent", "bind_commit"]
    # a pod's history, expanded along its trace and the node's context
    assert {e["kind"] for e in port["queries"][1]} >= {
        "agent_started", "bind_intent", "slow_span", "pod_reclaimed"}
    assert port["queries"][-1] == []


def test_the_cap_trims_the_oldest_and_counts_evictions(tmp):
    port = journal("port", tmp, cap=4)
    assert port == journal("agent", tmp, cap=4)
    assert len(port["rows"]) == 4 and port["cap_stored"] == 4
    assert port["status"]["evicted_total"] == 6
    assert [e["seq"] for e in port["rows"]] == [7, 8, 9, 10]


@pytest.mark.parametrize("writer", ["port", "agent"])
def test_a_db_reads_in_the_other_packages_timeline(tmp, writer):
    reader = "agent" if writer == "port" else "port"
    written = journal(writer, tmp, cap=6)
    tl_mod, store_cls = SIDES[reader][:2]
    with store_cls(os.path.join(tmp, f"{writer}.db")) as store:
        view = tl_mod.Timeline(store)
        assert store.timeline_rows() == written["rows"]
        assert [view.events(**q) for q in QUERIES] == written["queries"]
        assert view.status()["evicted_total"] == 4
        assert store.timeline_cap_stored() == 6
        # the reader journals on where the writer stopped
        view.emit(tl_mod.KIND_AGENT_STARTED, version="x")
        assert store.timeline_rows()[-1]["seq"] == 11


# -- the group-commit batcher --------------------------------------------------


def batcher_story(side):
    """A sync writer blocks until its commit lands; async writes ride one
    flush; a failed flush fails its sync waiter and rolls back."""
    bmod = SIDES[side][3]
    gate = threading.Event()
    log = []
    fail = [False]

    def commit():
        gate.wait(10)
        if fail[0]:
            raise RuntimeError("disk refused")
        log.append("commit")

    b = bmod.GroupCommitBatcher(commit, lambda: log.append("rollback"),
                                window_s=0.05, name=side)
    try:
        done = threading.Event()

        def sync_writer():
            b.wait(b.mark_dirty(sync=True))
            done.set()

        t = threading.Thread(target=sync_writer)
        t.start()
        blocked = not done.wait(0.05)      # its commit is held at the gate
        gate.set()
        assert done.wait(10)
        t.join()
        for _ in range(3):
            b.mark_dirty(sync=False)       # returns at once
        b.flush()
        gate.clear()
        fail[0] = True
        errors = []

        def failing_writer():
            try:
                b.wait(b.mark_dirty(sync=True))
            except bmod.GroupCommitError as e:
                errors.append(type(e).__name__)

        t = threading.Thread(target=failing_writer)
        t.start()
        gate.set()
        t.join(10)
        stats = b.stats()
        stats.pop("window_s")
        return blocked, log, errors, stats
    finally:
        gate.set()
        b.stop()


def test_batcher_waits_match_the_agents():
    port = batcher_story("port")
    assert port == batcher_story("agent")
    blocked, log, errors, stats = port
    assert blocked and log == ["commit", "commit", "rollback"]
    assert errors == ["GroupCommitError"]
    assert stats["writes_total"] == 5 and stats["commits_total"] == 2
    assert stats["flush_failures_total"] == 1


def store_visibility(side, root):
    """Under a window, a sync write (the checkpoint, the intent) is on
    disk when it returns: another connection reads it. An async one (the
    intent's commit, a timeline row) waits for the flush. A timeline
    append that itself opens the group's transaction commits it at once:
    its outermost SAVEPOINT's RELEASE is a COMMIT in sqlite."""
    _, store_cls, _, _, pod_cls = SIDES[side]
    path = os.path.join(root, f"{side}.db")
    store = store_cls(path, batch_window_s=0.3)
    try:
        other = sqlite3.connect(path)

        def count(table):
            return other.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]

        out = []
        store.save(pod_cls("ns", "a"))
        intent = store.journal_intent("ns/a", "main", "r", "h", {})
        out.append((count("pods"), count("bind_intents")))
        store.journal_commit(intent)             # async: rides the flush
        store.timeline_append(1.0, "bind_commit", {"pod": "ns/a"}, {}, 10)
        out.append((count("bind_intents"), count("timeline")))
        store._batcher.flush()
        out.append((count("bind_intents"), count("timeline")))
        store.timeline_append(2.0, "pod_reclaimed", {"pod": "ns/a"}, {}, 10)
        out.append(count("timeline"))            # opened and committed
        stats = store.write_stats()
        other.close()
        return out, stats["writes_total"], stats["commits_total"]
    finally:
        store.close()


def test_store_sync_and_async_writes_match_the_agents(tmp):
    port = store_visibility("port", tmp)
    assert port == store_visibility("agent", tmp)
    assert port[0] == [(1, 1), (1, 0), (0, 1), 2]


# -- crash points under the batch window ---------------------------------------


def crash_run(point, port):
    root = tempfile.mkdtemp(prefix="tc", dir="/tmp")
    node = Node(root, port)
    obs = dict(batch_window_s=0.005, timeline=True)
    try:
        node.boot(**obs)
        plant_crash(point)(node)
        gen = node.boot(**obs)         # the restarted agent, same window
        report = gen.reconciler.reconcile_once(boot=True)
        rows = gen.storage.timeline_rows()
        story = (timeline if port else agent_timeline).verify_bind_story(rows)
        kinds = [(e["kind"], e["attrs"].get("class"),
                  e["attrs"].get("reason")) for e in rows]
        return dict(report=report, state=node.state(), kinds=kinds,
                    story=story)
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("point", FAILPOINTS)
def test_crash_points_restore_under_a_batch_window(point):
    port, agent = crash_run(point, True), crash_run(point, False)
    rp = {k: v for k, v in port["report"].items() if k != "duration_s"}
    assert rp == port_report(agent["report"])
    assert to_agent(port["state"], hash_map()) == to_agent(agent["state"], {})
    assert port["kinds"] == agent["kinds"]
    assert port["story"] == [] and agent["story"] == []
    want = dict.fromkeys(("intents_committed", "intents_rolled_back",
                          "replayed_binds"), 0)
    want.update(CRASH_OUTCOME[point])
    assert {k: port["report"][k] for k in want} == want
    assert port["state"]["intents"] == 0
    assert len(port["state"]["records"]["default/a"]["allocations"][
        "main"]) == 2
