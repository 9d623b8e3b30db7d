"""The port's checkpoint store (``storage/store.py``) against the agent's.

One seeded sequence of operations (saves, mutates, deletes, bind intents
journaled, committed and released, agent-state documents) goes through
both stores; their records, open intents, counts and state documents must
be equal. A db written by either store opens in the other with the same
schema, a corrupt row shows in both stores' ``corrupt_keys``, and a close
and reopen keeps everything.
"""

import json
import sqlite3

import numpy as np
import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import types as agent_types  # noqa: E402
from elastic_tpu_agent.storage import Storage as AgentStorage  # noqa: E402
from elastic_tpu_agent.storage import StorageError as AgentError  # noqa: E402
from elastic_tpu_agent_torch import types as port_types  # noqa: E402
from elastic_tpu_agent_torch.storage import Storage, StorageError  # noqa: E402

SIDES = {"port": (Storage, StorageError, port_types),
         "agent": (AgentStorage, AgentError, agent_types)}
RESOURCES = ("elasticgpu.io/gpu-core", "elasticgpu.io/gpu-memory")


def script(seed: int, n: int = 60):
    """A seeded list of operations, in the vocabulary of ``apply``."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["save", "mutate", "delete", "intent", "commit",
                           "done", "state", "unstate"],
                          p=[.15, .3, .1, .15, .1, .05, .1, .05])
        pod = f"ns{rng.integers(2)}/pod-{rng.integers(6)}"
        chips = sorted(rng.choice(8, size=rng.integers(1, 3),
                                  replace=False).tolist())
        ids = [f"gpu-core-{chips[0]}-{u}"
               for u in rng.choice(100, size=rng.integers(1, 5),
                                   replace=False).tolist()]
        ops.append(dict(kind=str(kind), pod=pod, chips=chips, ids=ids,
                        container=f"c{rng.integers(2)}",
                        resource=RESOURCES[rng.integers(2)],
                        pick=int(rng.integers(1 << 30)),
                        value=int(rng.integers(1000))))
    return ops


def apply(store, types, ops):
    """Run ``ops`` on ``store``; intents are tracked by their order of
    creation, so that both stores release the same ones."""
    opened = []
    for op in ops:
        ns, name = op["pod"].split("/")
        if op["kind"] == "save":
            store.save(types.PodInfo(ns, name))
        elif op["kind"] == "mutate":
            rec = types.AllocationRecord(
                device=types.Device(op["ids"], op["resource"]),
                chip_indexes=op["chips"],
                created_node_ids=[f"h-{p}" for p in range(len(op["chips"]))])
            store.mutate(ns, name, lambda info, r=rec, c=op["container"]:
                         info.set_allocation(c, r))
        elif op["kind"] == "delete":
            store.delete(ns, name)
        elif op["kind"] == "intent":
            opened.append(store.journal_intent(
                op["pod"], op["container"], op["resource"],
                types.Device(op["ids"], op["resource"]).hash,
                {"device_ids": op["ids"], "chip_indexes": op["chips"],
                 "planned_link_ids": [f"h-{p}" for p in
                                      range(len(op["chips"]))]}))
        elif op["kind"] in ("commit", "done") and opened:
            intent_id = opened.pop(op["pick"] % len(opened))
            if op["kind"] == "commit":
                store.journal_commit(intent_id)
            else:
                store.intent_done(intent_id)
        elif op["kind"] == "state":
            store.save_state(f"key-{op['value'] % 3}",
                             {"v": op["value"], "pod": op["pod"]})
        elif op["kind"] == "unstate":
            store.delete_state(f"key-{op['value'] % 3}")
    return opened


def reading(store):
    """Everything the two stores must agree on (the intents without their
    wall-clock times)."""
    return dict(
        items={k: json.loads(v.to_json()) for k, v in store.items()},
        intents=[{k: v for k, v in i.items()
                  if k not in ("created_ts", "age_s")}
                 for i in store.open_intents()],
        brief=[{k: v for k, v in i.items() if k != "age_s"}
               for i in store.open_intents_brief()],
        count=store.count(),
        states={k: store.load_state(f"key-{k}") for k in range(3)},
        corrupt=store.corrupt_keys(),
    )


def schema(path):
    db = sqlite3.connect(path)
    try:
        return sorted(db.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master"
        ).fetchall(), key=lambda r: (r[0], r[1]))
    finally:
        db.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_script_reads_the_same_in_both(tmp_path, seed):
    ops = script(seed)
    got = {}
    for side, (cls, _, types) in SIDES.items():
        store = cls(str(tmp_path / f"{side}.db"))
        try:
            opened = apply(store, types, ops)
            got[side] = reading(store)
            got[side]["inflight"] = [store.intent_inflight(i) for i in opened]
            got[side]["open"] = [store.intent_open(i) for i in opened]
        finally:
            store.close()
    assert got["port"] == got["agent"]
    assert got["port"]["items"] and got["port"]["intents"]


@pytest.mark.parametrize("writer,reader", [("agent", "port"),
                                           ("port", "agent")])
def test_a_db_written_by_one_opens_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "meta.db")
    w_cls, _, w_types = SIDES[writer]
    store = w_cls(path)
    apply(store, w_types, script(7))
    before = reading(store)
    store.close()
    r_cls, _, r_types = SIDES[reader]
    store = r_cls(path)
    try:
        after = reading(store)
        # the reader keeps writing where the writer stopped
        apply(store, r_types, script(8, n=20))
    finally:
        store.close()
    assert after == before
    assert schema(path) == schema(_fresh_db(tmp_path, reader))


def _fresh_db(tmp_path, side):
    path = str(tmp_path / f"fresh-{side}.db")
    SIDES[side][0](path).close()
    return path


def test_both_create_the_agents_five_tables(tmp_path):
    port, agent = (schema(_fresh_db(tmp_path, s)) for s in ("port", "agent"))
    assert port == agent
    assert {r[1] for r in port if r[0] == "table"} >= {
        "pods", "bind_intents", "agent_state", "timeline", "timeline_meta"}


@pytest.mark.parametrize("side", ["port", "agent"])
def test_corrupt_row_shows_in_corrupt_keys(tmp_path, side):
    cls, err, types = SIDES[side]
    path = str(tmp_path / "meta.db")
    store = cls(path)
    apply(store, types, script(3))
    good = sorted(k for k, _ in store.items())
    store.close()
    db = sqlite3.connect(path)
    db.execute("INSERT INTO pods(key, value) VALUES('ns0/bad', '{not json')")
    db.execute("INSERT INTO agent_state(key, value, updated_ts) "
               "VALUES('key-9', '[1', 0)")
    db.commit()
    db.close()
    store = cls(path)
    try:
        assert store.corrupt_keys() == ["ns0/bad"]
        assert sorted(k for k, _ in store.items()) == good
        with pytest.raises(err):
            store.load("ns0", "bad")
        assert store.load_state("key-9") is None
    finally:
        store.close()


def test_corrupt_keys_agree_after_a_foreign_write(tmp_path):
    """A write through another connection drops both stores' caches."""
    seen = {}
    for side, (cls, _, types) in SIDES.items():
        path = str(tmp_path / f"{side}.db")
        store = cls(path)
        try:
            apply(store, types, script(4))
            warm = store.corrupt_keys()
            db = sqlite3.connect(path)
            db.execute("UPDATE pods SET value='[' WHERE key IN "
                       "(SELECT key FROM pods ORDER BY key LIMIT 1)")
            db.commit()
            db.close()
            seen[side] = (warm, store.corrupt_keys(), store.count())
        finally:
            store.close()
    assert seen["port"] == seen["agent"]
    assert seen["port"][0] == [] and len(seen["port"][1]) == 1


def test_close_and_reopen_keeps_everything(tmp_path):
    path = str(tmp_path / "meta.db")
    store = Storage(path)
    opened = apply(store, port_types, script(5))
    before = reading(store)
    store.close()
    with Storage(path) as store:
        assert reading(store) == before
        # the in-flight markers die with the process's store; the rows
        # stay for the reconciler
        assert not any(store.intent_inflight(i) for i in opened)
        assert [store.intent_open(i) for i in opened] == [True] * len(opened)


def test_mutate_serializes_one_pod(tmp_path):
    """Two threads mutating one pod lose no update."""
    import threading

    store = Storage(str(tmp_path / "meta.db"))
    try:
        def work(c):
            for u in range(20):
                rec = port_types.AllocationRecord(
                    device=port_types.Device([f"gpu-core-0-{u}"],
                                             RESOURCES[0]),
                    chip_indexes=[0], created_node_ids=[])
                store.mutate("ns", "p", lambda info, r=rec, k=f"{c}{u}":
                             info.set_allocation(k, r))
        threads = [threading.Thread(target=work, args=(c,)) for c in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(store.load("ns", "p").allocations) == 40
    finally:
        store.close()
