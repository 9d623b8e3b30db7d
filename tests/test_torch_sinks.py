"""The port's async sinks (``async_sink.py``), k8s Events
(``kube/events.py``) and ElasticTPU CRD recorder (``crd.py``,
``crd_recorder.py``) against the agent's.

``AsyncSink``: the same submissions, made while a gate op holds the worker
so that each drain sees the same queue, give the same op log, ``merged``
(same-key ops coalesced), ``dropped`` (the queue's bound, an op that
fails on its own ``max_failures`` times, the tail of a disabled sink),
the shared backoff's retries, self-disable after a streak of failed
flushes, and the drop hook's count. Then one node's flow against
``tests/fake_apiserver.py`` on each side (``tests/torch_agent_rig.py``):
the card inventory, three binds, a refused bind, a card's health flip
and back, a pod deleted and reclaimed by GC, and a boot reconcile; the
Event bodies and the ElasticTPU objects equal the agent's once the
port's resource names, card wording, hashes and trace ids are mapped.
"""

import json
import re
import shutil
import tempfile
import threading

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import async_sink as agent_sink  # noqa: E402
from elastic_tpu_agent import crd_recorder as agent_crd  # noqa: E402
from elastic_tpu_agent.kube import events as agent_events  # noqa: E402
from elastic_tpu_agent.kube.client import KubeClient as AgentKube  # noqa: E402
from elastic_tpu_agent_torch import async_sink, crd, crd_recorder  # noqa: E402
from elastic_tpu_agent_torch.kube import events  # noqa: E402
from elastic_tpu_agent_torch.kube.client import KubeClient  # noqa: E402

from fake_apiserver import FakeAPIServer  # noqa: E402
from torch_agent_rig import UNITS, Node  # noqa: E402

SINKS = {"port": async_sink, "agent": agent_sink}


class Drops:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1


def sink_story(side, story):
    mod = SINKS[side]
    log, drops = [], Drops()
    sink = mod.AsyncSink(f"{side}-sink", max_failures=3, max_queue=4,
                         on_drop=drops.inc, backoff_min_s=0.001,
                         backoff_max_s=0.002)
    gate = threading.Event()

    def held():
        gate.wait(10)
        log.append("gate")

    def op(name, fails=0):
        left = [fails]

        def run():
            if left[0] > 0:
                left[0] -= 1
                log.append(f"{name}!")
                raise RuntimeError(name)
            log.append(name)
        return run

    try:
        story(sink, held, op, gate)
        assert sink.flush(10)
        return (log, sink.merged, sink.dropped, drops.n, sink.disabled,
                sink.writes_total, sink.consecutive_failures)
    finally:
        gate.set()
        sink.stop(5)


def story_coalesce(sink, held, op, gate):
    """Same-key ops collapse to the newest; a full queue drops the
    oldest."""
    sink.submit(held)
    assert sink.queue_depth == 1 or sink.queue_depth == 0
    import time
    while sink.queue_depth:              # the worker took the gate op
        time.sleep(0.001)
    sink.submit(op("a1"), key="a")
    sink.submit(op("b"))
    sink.submit(op("a2"), key="a")       # supersedes a1
    for i in range(4):
        sink.submit(op(f"c{i}"))         # the bound of 4 drops the oldest
    gate.set()


def story_backoff(sink, held, op, gate):
    """A flaky op fails twice and lands on the shared backoff's third
    try; one that always fails is dropped after its own 3 failures while
    the op behind it lands."""
    sink.submit(op("flaky", fails=2))
    sink.submit(op("after"))
    assert sink.flush(10)
    sink.submit(op("bad", fails=99), key="bad")
    sink.submit(op("next"))
    gate.set()


def story_disable(sink, held, op, gate):
    """Every flush fails: the sink disables itself after 3, counts the
    tail it drops and refuses later submissions."""
    import time
    sink.submit(held)
    while sink.queue_depth:
        time.sleep(0.001)
    for name in ("x", "y", "z"):
        sink.submit(op(name, fails=99), key=name)
    gate.set()
    deadline = time.monotonic() + 10
    while not sink.disabled and time.monotonic() < deadline:
        time.sleep(0.001)
    sink.submit(op("refused"))


STORIES = {"coalesce": story_coalesce, "backoff": story_backoff,
           "disable": story_disable}


@pytest.mark.parametrize("name", sorted(STORIES))
def test_async_sink_matches_the_agents(name):
    port = sink_story("port", STORIES[name])
    assert port == sink_story("agent", STORIES[name])
    log, merged, dropped, hook, disabled, writes, streak = port
    if name == "coalesce":
        # a2 took a1's key, then c2 and c3 pushed b and a2 out
        assert log == ["gate", "c0", "c1", "c2", "c3"]
        assert merged == 1 and dropped == hook == 2
    if name == "backoff":
        assert log == ["flaky!", "flaky!", "flaky", "after", "bad!",
                       "bad!", "bad!", "next"]
        assert dropped == 1 and not disabled and streak == 0
    if name == "disable":
        assert disabled and dropped == hook == 3 and "refused" not in log


# -- Events and ElasticTPU objects from one node's flow ------------------------

TRACE = re.compile(r"\[trace [0-9a-f]{16}\]")
WORDS = (("elastic-gpushare-", "elastic-tpushare-"), ("gpu-core", "tpu-core"),
         ("gpu-mem", "tpu-mem"), ("GPU card(s)", "TPU chip(s)"),
         ("GPU card ", "TPU chip "), ("GPU allocation", "TPU allocation"),
         ("GiB memory", "GiB HBM"), (" SM(s)", " core(s)"),
         ('"card recovered"', '"chip recovered"'), ('"card ', '"chip '))


def flow(port: bool):
    api = FakeAPIServer()
    url = api.start()
    root = tempfile.mkdtemp(prefix="sk", dir="/tmp")
    node = Node(root, port)
    try:
        client = (KubeClient if port else AgentKube)(url)
        ev = (events if port else agent_events).EventRecorder(client,
                                                              "node-a")
        gen0 = node.boot()
        rec = (crd_recorder if port else agent_crd).build_recorder(
            client, "node-a", gen0.operator)
        gen = node.boot(events=ev, crd_recorder=rec)
        rec.publish_inventory(gen.operator.devices())
        node.annotate("a", "2")
        node.annotate("b", "1")
        node.sitter.add_pod("default", "c", {})        # not assumed
        hashes = [node.bind("core", "a", 2, range(50)),
                  node.bind("mem", "a", 2, range(UNITS // 4)),
                  node.bind("core", "b", 1, range(25))]
        with pytest.raises(Exception):
            node.bind("core", "c", 3, range(10))
        hashes.append(node.device("core", node.ids("core", 3,
                                                   range(10))).hash)
        gen.operator.set_unhealthy({1})
        gen.plugin.health_once()
        gen.operator.set_unhealthy(set())
        gen.plugin.health_once()
        node.sitter.remove_pod("default", "a")
        node.kubelet.unassign_pod("default", "a")
        assert gen.plugin.gc_once() == 1
        gen.reconciler.reconcile_once(boot=True)
        assert rec.flush(10) and ev.flush(10)
        bodies = sorted(
            (json.dumps({k: v for k, v in e.items()
                         if k not in ("metadata", "firstTimestamp",
                                      "lastTimestamp")}, sort_keys=True)
             for e in api.core_events))
        objects = {name: {k: v for k, v in obj.items() if k != "metadata"}
                   for name, obj in api._crds.items()}
        labels = {name: obj["metadata"].get("labels")
                  for name, obj in api._crds.items()}
        ev.stop(5)
        rec.stop(5)
        return dict(events=bodies, objects=objects, labels=labels,
                    hashes=hashes)
    finally:
        node.close()
        api.stop()
        shutil.rmtree(root, ignore_errors=True)


def mapped(obj, hashes):
    text = json.dumps(obj, sort_keys=True)
    for mine, theirs in hashes.items():
        text = text.replace(mine, theirs)
    for mine, theirs in WORDS:
        text = text.replace(mine, theirs)
    return json.loads(TRACE.sub("[trace <t>]", text))


@pytest.fixture(scope="module")
def flows():
    return {"port": flow(True), "agent": flow(False)}


def test_event_bodies_match_the_agents(flows):
    port, agent = flows["port"], flows["agent"]
    hashes = dict(zip(port["hashes"], agent["hashes"]))
    assert sorted(mapped(port["events"], hashes)) == sorted(
        mapped(agent["events"], {}))
    reasons = sorted(json.loads(e)["reason"] for e in port["events"])
    assert reasons == sorted(["TPUBound"] * 3 + ["TPUBindFailed",
                                                 "TPUChipUnhealthy",
                                                 "TPUChipUnhealthy",
                                                 "TPUChipHealthy",
                                                 "TPUReclaimed"])


def test_elastictpu_objects_match_the_agents(flows):
    port, agent = flows["port"], flows["agent"]
    hashes = dict(zip(port["hashes"], agent["hashes"]))
    assert mapped(port["objects"], hashes) == mapped(agent["objects"], {})
    assert mapped(port["labels"], hashes) == mapped(agent["labels"], {})
    phases = {n: o["status"]["phase"] for n, o in port["objects"].items()}
    # pod a's two objects were released and removed; b's stays Bound;
    # four cards of inventory, card 1 back to Available
    assert phases == {f"node-a-{port['hashes'][2]}": "Bound",
                      **{f"node-a-chip{i}": "Available" for i in range(4)}}
    obj = port["objects"][f"node-a-{port['hashes'][2]}"]
    assert obj["spec"]["capacity"] == {"elasticgpu.io/gpu-core": "25"}
    assert obj["spec"]["source"]["physicalTPU"]["chipIndexes"] == [1]
    assert obj["apiVersion"] == f"{crd.GROUP}/{crd.VERSION}" == \
        "elasticgpu.io/v1alpha1" and obj["kind"] == "ElasticTPU"
