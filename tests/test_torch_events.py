"""The port's event bus (``events.py``) and its publishers and subscriber
against the agent's.

The same publish-and-subscribe script runs on each package's
``EventBus`` under its ``ManualClock``: deliveries (topic, kind, key,
timestamp, sequence number, payload), drops of a full queue, a crashing
callback counted and contained, ``suppress``, degraded mode's
``BUS_WAKE`` broadcast, ``healthy()`` and ``stats()``, and
``wait_trigger``'s answers. Then the publishers (the sitter's pod deltas
from the watch, the locator's assignment deltas,
the store's notes after each commit, batched or not) and the
reconciler's targeted pass on a pod delta, side by side through
``tests/torch_agent_rig.py`` and ``tests/fake_apiserver.py``.
"""

import shutil
import tempfile
import threading
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import common as agent_common  # noqa: E402
from elastic_tpu_agent import events as agent_events  # noqa: E402
from elastic_tpu_agent.kube.client import KubeClient as AgentKube  # noqa: E402
from elastic_tpu_agent.kube.sitter import Sitter as AgentSitter  # noqa: E402
from elastic_tpu_agent.storage import Storage as AgentStorage  # noqa: E402
from elastic_tpu_agent.types import PodInfo as AgentPodInfo  # noqa: E402
from elastic_tpu_agent_torch import common, events  # noqa: E402
from elastic_tpu_agent_torch.kube.client import KubeClient  # noqa: E402
from elastic_tpu_agent_torch.kube.sitter import Sitter  # noqa: E402
from elastic_tpu_agent_torch.storage import Storage  # noqa: E402
from elastic_tpu_agent_torch.types import PodInfo  # noqa: E402

from fake_apiserver import FakeAPIServer, make_pod  # noqa: E402
from torch_agent_rig import UNITS, Node  # noqa: E402

SIDES = {"port": (events, common), "agent": (agent_events, agent_common)}


def wait_until(fn, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if fn():
            return True
        time.sleep(0.005)
    return fn()


def _ev(e):
    return (e.topic, e.kind, e.key, e.ts, e.seq, dict(e.payload))


def script_overflow(ev, bus, clock, log):
    """A queue of cap 3 takes 5 events: the oldest two drop."""
    sub = bus.subscribe("small", [ev.POD_DELTA], cap=3)
    for i in range(5):
        clock.advance(0.5)
        log.append(bus.publish(ev.POD_DELTA, "added", f"ns/p{i}",
                               {"uid": f"u{i}"}))
    log.append([_ev(e) for e in sub.drain()])
    log.append(sub.stats())


def script_topics(ev, bus, clock, log):
    """Topic filters, a callback subscriber, one that raises, and an
    unknown topic refused at subscribe."""
    seen = []
    a = bus.subscribe("rec", [ev.POD_DELTA, ev.STORE_BIND])
    b = bus.subscribe("cb", [ev.STORE_BIND], callback=lambda e: seen.append(
        _ev(e)))
    bus.subscribe("boom", [ev.STORE_INTENT],
                  callback=lambda e: 1 / 0)
    for topic, kind, key in ((ev.STORE_BIND, "save", "ns/a"),
                             (ev.ASSIGNMENT_DELTA, "added", "h1"),
                             (ev.STORE_INTENT, "open", "7"),
                             (ev.POD_DELTA, "deleted", "ns/a")):
        clock.advance(1.0)
        log.append(bus.publish(topic, kind, key))
    log.append([_ev(e) for e in a.drain()])
    log.append(seen)
    log.append(sorted((s["name"], s["delivered"], s["callback_errors"])
                      for s in bus.stats()["subscribers"]))
    with pytest.raises(ValueError):
        bus.subscribe("bad", ["no.such.topic"])
    b.close()
    log.append(bus.publish(ev.STORE_BIND, "delete", "ns/a"))


def script_degraded(ev, bus, clock, log):
    """Degraded mode wakes every subscriber, whatever its topics; a
    second source flips nothing; recovery wakes them again."""
    a = bus.subscribe("a", [ev.POD_DELTA])
    b = bus.subscribe("b", [ev.STORE_STATE])
    for source, flag in (("sitter-watch", True), ("other", True),
                         ("sitter-watch", False), ("other", False)):
        clock.advance(2.0)
        bus.set_degraded(source, flag)
        log.append((bus.healthy(), bus.degraded_sources()))
    log.append([_ev(e) for e in a.drain()])
    log.append([_ev(e) for e in b.drain()])


def script_suppress_and_wait(ev, bus, clock, log):
    """suppress swallows the next publishes of a topic (counted);
    wait_trigger answers event, poll or stop."""
    sub = bus.subscribe("w", [ev.STORE_BIND])
    bus.suppress(ev.STORE_BIND, 2)
    for i in range(3):
        log.append(bus.publish(ev.STORE_BIND, "save", f"ns/{i}"))
    log.append(sub.wait_trigger(None, 0.0))
    log.append([_ev(e) for e in sub.drain()])
    log.append(sub.wait_trigger(None, 0.0))
    stop = threading.Event()
    stop.set()
    log.append(sub.wait_trigger(stop, 5.0))
    stats = bus.stats()
    log.append({k: stats[k] for k in ("published_total",
                                      "published_by_topic",
                                      "suppressed_total", "drops_total")})


SCRIPTS = {"overflow": script_overflow, "topics": script_topics,
           "degraded": script_degraded,
           "suppress_and_wait": script_suppress_and_wait}


def run_script(side, name):
    ev, com = SIDES[side]
    clock = com.ManualClock()
    bus = ev.EventBus(clock=clock, default_cap=8)
    log = []
    SCRIPTS[name](ev, bus, clock, log)
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_bus_script_matches_the_agents(name):
    port = run_script("port", name)
    assert port == run_script("agent", name)
    if name == "overflow":
        assert port[-1]["drops"] == 2 and len(port[-2]) == 3
    if name == "degraded":
        assert port[:4] == [(False, ["sitter-watch"]),
                            (False, ["other", "sitter-watch"]),
                            (False, ["other"]), (True, [])]


# -- publishers ----------------------------------------------------------------


def _store_notes(side, window):
    """Every note a store publishes for a save, a journal open and
    commit, a state write and a delete, with or without group commit:
    after the covering commit, in order."""
    ev = SIDES[side][0]
    root = tempfile.mkdtemp(prefix="ev", dir="/tmp")
    bus = ev.EventBus()
    sub = bus.subscribe("s", [ev.STORE_BIND, ev.STORE_INTENT,
                              ev.STORE_STATE])
    store = (Storage if side == "port" else AgentStorage)(
        f"{root}/meta.db", batch_window_s=window, bus=bus)
    try:
        pod = (PodInfo if side == "port" else AgentPodInfo)("ns", "a")
        store.save(pod)
        intent = store.journal_intent("ns/a", "main", "r", "h", {})
        store.journal_commit(intent)
        store.save_state("drain", {"state": "idle"})
        store.delete("ns", "a")
        store.close()        # flushes the batcher's async tail
        return [(e.topic, e.kind, e.key) for e in sub.drain()]
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("window", [0.0, 0.005])
def test_store_notes_match_the_agents(window):
    port = _store_notes("port", window)
    assert port == _store_notes("agent", window)
    assert ("store.bind", "save", "ns/a") in port
    assert port[-1] == ("store.bind", "delete", "ns/a")


def _sitter_deltas(side):
    """Pod deltas off the watch: added, modified, deleted; the bus stays
    healthy while the watch runs."""
    ev = SIDES[side][0]
    api = FakeAPIServer()
    url = api.start()
    bus = ev.EventBus()
    sub = bus.subscribe("s", [ev.POD_DELTA])
    deleted = []
    sitter = (Sitter if side == "port" else AgentSitter)(
        (KubeClient if side == "port" else AgentKube)(url), "node-a",
        on_delete=deleted.append, bus=bus)
    stop = threading.Event()
    t = threading.Thread(target=sitter.run, args=(stop,), daemon=True)
    try:
        t.start()
        assert sitter.wait_synced(10)
        pod = make_pod("default", "a", "node-a")
        api.upsert_pod(pod)
        api.upsert_pod(pod)
        api.delete_pod("default", "a")
        assert wait_until(lambda: len(deleted) == 1)
        assert wait_until(lambda: sub.pending() >= 3)
        got = [(e.kind, e.key) for e in sub.drain()]
        return got, bus.healthy()
    finally:
        # the daemon thread's watch read ends with the server's window
        stop.set()
        api.stop()


def test_sitter_publishes_pod_deltas_as_the_agent():
    port = _sitter_deltas("port")
    assert port == _sitter_deltas("agent")
    assert port == ([("added", "default/a"), ("modified", "default/a"),
                     ("deleted", "default/a")], True)


def _assignment_deltas(port):
    ev = SIDES["port" if port else "agent"][0]
    root = tempfile.mkdtemp(prefix="ev", dir="/tmp")
    node = Node(root, port)
    try:
        bus = ev.EventBus()
        sub = bus.subscribe("s", [ev.ASSIGNMENT_DELTA])
        gen = node.boot(bus=bus)
        gen.source.assignments()               # the first List: a baseline
        node.kubelet.assign("default", "a", "main", node.res("core"),
                            node.ids("core", 1, range(10)))
        gen.source.invalidate()
        gen.source.assignments()
        node.kubelet.unassign_pod("default", "a")
        gen.source.invalidate()
        gen.source.assignments()
        return [(e.kind, e.payload["owner"]) for e in sub.drain()]
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def test_locator_publishes_assignment_deltas_as_the_agent():
    port = _assignment_deltas(True)
    assert port == _assignment_deltas(False)
    assert port == [("added", "default/a/main"),
                    ("removed", "default/a/main")]


def _targeted_pass(port):
    """The reconciler's loop at a period of an hour: a pod delta wakes a
    targeted pass that reclaims the dead pod's binding at once."""
    ev = SIDES["port" if port else "agent"][0]
    root = tempfile.mkdtemp(prefix="ev", dir="/tmp")
    node = Node(root, port)
    stop = threading.Event()
    try:
        bus = ev.EventBus()
        gen = node.boot(bus=bus)
        gen.reconciler.period_s = 3600.0
        gen.reconciler.event_safety_net_factor = 1.0
        node.annotate("a", "2")
        node.bind("mem", "a", 2, range(UNITS // 4))
        t = threading.Thread(target=gen.reconciler.run, args=(stop,),
                             daemon=True)
        t.start()
        node.sitter.remove_pod("default", "a")
        node.kubelet.unassign_pod("default", "a")
        bus.publish(ev.POD_DELTA, "deleted", "default/a")
        assert wait_until(lambda: gen.storage.load("default", "a") is None)
        stop.set()
        t.join(5)
        st = gen.reconciler.status()
        return (st["runs_total"] >= 1, st["repairs_total"],
                st["events"]["event_passes_total"] >= 1,
                st["events"]["subscription"]["topics"])
    finally:
        stop.set()
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def test_reconciler_runs_a_targeted_pass_on_a_pod_delta():
    port = _targeted_pass(True)
    assert port == _targeted_pass(False)
    assert port[:3] == (True, {"reclaimed_pod": 1}, True)
