"""The port's reconciler and bind journal (``reconciler.py``,
``plugins/gpushare.py``) against the agent's.

The port's plugins and reconciler and the agent's ``TPUSharePlugin`` and
``Reconciler`` each run behind their own fake kubelet, storage and 4-card
stub (``tests/torch_agent_rig.py``). The same states are planted in both:
wiped links, a missing spec, a dead pod, an orphan link and spec, a crash
at each of the five ``bind.*`` points (``die-thread`` around an
in-process bind, then a second generation booted on the surviving store,
as ``tests/test_reconciler.py`` does for the agent), and a kubelet
device-id drift. ``reconcile_once(boot=True)`` of a new generation must
give equal reports (the agent's slice keys read 0) and equal records,
links and spec files once the names are mapped; a dry-run pass repairs
nothing in either.
"""

import os
import shutil
import tempfile

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import faults as agent_faults  # noqa: E402
from elastic_tpu_agent_torch import faults  # noqa: E402

from torch_agent_rig import UNITS, Node, port_report, to_agent  # noqa: E402

FAILPOINTS = ["bind.pre_journal", "bind.post_journal", "bind.post_create",
              "bind.post_spec", "bind.post_checkpoint"]
# What the boot pass reports after a crash of pod a's core bind at each
# point, its memory bind committed and the kubelet's assignment standing
# (the port's and the agent's reports are also held equal below).
# chip_smoke.py's phase 26 expects the bind.post_create row.
CRASH_OUTCOME = {
    "bind.pre_journal": dict(replayed_binds=1),
    "bind.post_journal": dict(intents_rolled_back=1, replayed_binds=1),
    "bind.post_create": dict(intents_rolled_back=1, replayed_binds=1),
    "bind.post_spec": dict(intents_rolled_back=1, replayed_binds=1),
    "bind.post_checkpoint": dict(intents_committed=1),
}


def base(node):
    """Pod a: 50 core units and a quarter of the memory units of card 2;
    pod b: 100 core ids of card 1 that the scheduler placed on cards 3
    and 1. Returns the port-side binds as (kind, chip, units) tuples."""
    node.annotate("a", "2")
    node.annotate("b", "3,1")
    binds = [("core", "a", 2, range(50)), ("mem", "a", 2, range(UNITS // 4)),
             ("core", "b", 1, range(100))]
    for kind, pod, chip, units in binds:
        node.bind(kind, pod, chip, units)
    return binds


def plant_wiped_links(node):
    base(node)
    for name in os.listdir(node.dev_root):
        os.unlink(os.path.join(node.dev_root, name))


def plant_missing_spec(node):
    base(node)
    h = node.device("core", node.ids("core", 1, range(100))).hash
    os.unlink(os.path.join(node.alloc_dir, f"{h}.json"))


def plant_dead_pod(node):
    base(node)
    node.sitter.remove_pod("default", "a")
    node.kubelet.unassign_pod("default", "a")


def plant_orphans(node):
    base(node)
    node.gen.operator.create(0, "0badbeef-0")
    os.makedirs(os.path.join(node.alloc_dir, "usage"), exist_ok=True)
    for path in ("0badf00d.json", "0badf00d.json.tmp", "usage/0badf00d.json"):
        with open(os.path.join(node.alloc_dir, path), "w") as f:
            f.write("{}")


def plant_drift(node):
    """A kubelet restart handed pod b's container other core ids."""
    base(node)
    node.kubelet.assign("default", "b", "main", node.res("core"),
                        node.ids("core", 3, range(100)))


def plant_crash(point):
    def plant(node):
        node.annotate("a", "2")
        node.bind("mem", "a", 2, range(UNITS // 4))
        ids = node.ids("core", 2, range(50))
        node.kubelet.assign("default", "a", "main", node.res("core"), ids)
        f = faults if node.port else agent_faults
        with f.armed(point, "die-thread:1"):
            with pytest.raises(f.DieThread):
                node.gen.plugin.core._bind(node.device("core", ids))
    return plant


SCENARIOS = {
    "wiped_links": plant_wiped_links,
    "missing_spec": plant_missing_spec,
    "dead_pod": plant_dead_pod,
    "orphans": plant_orphans,
    "drift": plant_drift,
    **{f"crash_{p.split('.')[1]}": plant_crash(p) for p in FAILPOINTS},
}
# every device set a scenario binds, as (kind, chip, units)
DEVICE_SETS = [("core", 2, range(50)), ("mem", 2, range(UNITS // 4)),
               ("core", 1, range(100)), ("core", 3, range(100))]


def run(name, port, dry_run=False):
    root = tempfile.mkdtemp(prefix="rc", dir="/tmp")
    node = Node(root, port)
    try:
        node.boot()
        SCENARIOS[name](node)
        planted = node.state()
        gen = node.boot(dry_run=dry_run)     # the restarted agent
        report = gen.reconciler.reconcile_once(boot=not dry_run)
        out = dict(report=report, planted=planted, state=node.state(),
                   status=gen.reconciler.status())
        if not dry_run:
            # converged: a second boot pass finds nothing to do
            out["again"] = gen.reconciler.reconcile_once(boot=True)
        return out
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def hash_map():
    """The port's hash of each device set -> the agent's."""
    port, agent = Node.__new__(Node), Node.__new__(Node)
    port.port, agent.port = True, False
    return {port.device(k, port.ids(k, c, u)).hash:
            agent.device(k, agent.ids(k, c, u)).hash
            for k, c, u in DEVICE_SETS}


def compare(name, dry_run=False):
    port, agent = run(name, True, dry_run), run(name, False, dry_run)
    hashes = hash_map()
    rp = {k: v for k, v in port["report"].items() if k != "duration_s"}
    assert rp == port_report(agent["report"])
    for key in ("planted", "state"):
        assert to_agent(port[key], hashes) == to_agent(agent[key], {}), key
    if not dry_run:
        assert port["again"]["repaired_total"] == 0
        assert agent["again"]["repaired_total"] == 0
    return port


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_boot_pass_matches_the_agents(name):
    port = compare(name)
    report, state = port["report"], port["state"]
    assert state["intents"] == 0
    assert report["snapshot_error"] is None and report["boot"]
    if name.startswith("crash_"):
        point = "bind." + name[len("crash_"):]
        want = dict.fromkeys(("intents_committed", "intents_rolled_back",
                              "replayed_binds"), 0)
        want.update(CRASH_OUTCOME[point])
        assert {k: report[k] for k in want} == want
        assert len(state["records"]["default/a"]["allocations"]["main"]) == 2
    elif name == "wiped_links":
        assert report["restored_links"] == 4
        # cards 2, 2, 1 and 3 at minors 3, 3, 0 and 1
        assert sorted(state["links"].values()) == [
            "/dev/nvidia0", "/dev/nvidia1", "/dev/nvidia3", "/dev/nvidia3"]
    elif name == "missing_spec":
        assert report["restored_specs"] == 1
    elif name == "dead_pod":
        assert report["reclaimed_pods"] == 1
        assert list(state["records"]) == ["default/b"]
    elif name == "orphans":
        assert report["orphan_links"] == 1 and report["orphan_specs"] == 2
        assert not any("0bad" in n for n in state["links"])
        assert not any("0bad" in n for n in state["specs"])
    elif name == "drift":
        assert report["rebound_drift"] == 1


@pytest.mark.parametrize("name", ["wiped_links", "dead_pod", "orphans",
                                  "drift", "crash_post_create"])
def test_dry_run_repairs_nothing(name):
    port = compare(name, dry_run=True)
    report = port["report"]
    assert report["repaired_total"] == 0 and report["dry_run"]
    assert report["divergences_observed"] > 0
    assert port["state"] == port["planted"]
    assert port["status"]["pending_confirmation"] >= 0


def test_periodic_pass_confirms_an_absence_twice():
    """An unbound kubelet assignment is replayed by a periodic pass only
    when the next pass sees it again (a boot pass acts at once)."""
    root = tempfile.mkdtemp(prefix="rc", dir="/tmp")
    node = Node(root, True)
    try:
        gen = node.boot()
        node.annotate("a", "2")
        node.kubelet.assign("default", "a", "main", node.res("core"),
                            node.ids("core", 2, range(10)))
        first = gen.reconciler.reconcile_once()
        second = gen.reconciler.reconcile_once()
        assert (first["replayed_binds"], first["pending_confirmation"]) == \
            (0, 1)
        assert second["replayed_binds"] == 1
        assert gen.reconciler.status()["repairs_total"] == {
            "replayed_bind": 1}
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def test_an_intent_in_flight_is_never_resolved():
    """A live bind's intent (the in-process marker set) is left alone."""
    root = tempfile.mkdtemp(prefix="rc", dir="/tmp")
    node = Node(root, True)
    try:
        gen = node.boot()
        intent = gen.storage.journal_intent(
            "default/a", "main", node.res("core"), "feedface",
            {"planned_link_ids": ["feedface-0"], "chip_indexes": [0]})
        report = gen.reconciler.reconcile_once(boot=True)
        assert report["intents_rolled_back"] == 0
        assert gen.storage.intent_open(intent)
        gen.storage.intent_done(intent)
        report = gen.reconciler.reconcile_once(boot=True)
        assert report["intents_rolled_back"] == 1
        assert gen.storage.open_intents() == []
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("admission", ["", "feedfacecafebeef"])
def test_prestart_stamps_its_trace_id_into_the_spec(admission):
    """The spec's ELASTIC_TPU_TRACE_ID is the PreStart trace's id (an
    admission-stamped id when the pod carries one, as the agent adopts
    it), and the trace is in the tracer's ring under the pod."""
    import json

    from elastic_tpu_agent_torch.common import AnnotationTraceID
    from elastic_tpu_agent_torch.tracing import Tracer, set_tracer

    root = tempfile.mkdtemp(prefix="rc", dir="/tmp")
    node = Node(root, True)
    prev = set_tracer(Tracer())
    try:
        node.boot()
        node.annotate("a", "2")
        if admission:
            node.sitter.pods[("default", "a")]["metadata"]["annotations"][
                AnnotationTraceID] = admission
        ids = node.ids("core", 2, range(10))
        node.kubelet.assign("default", "a", "main", node.res("core"), ids)
        node.gen.plugin.core.pre_start(ids)
        h = node.device("core", ids).hash
        with open(os.path.join(node.alloc_dir, f"{h}.json")) as f:
            stamped = json.load(f)["env"]["ELASTIC_TPU_TRACE_ID"]
        from elastic_tpu_agent_torch.tracing import get_tracer

        traces = get_tracer().dump(pod="default/a")
        assert [t["name"] for t in traces] == ["PreStartContainer"]
        assert traces[0]["trace_id"] == stamped
        assert stamped == (admission or traces[0]["trace_id"])
        assert "checkpoint" in [sp["name"] for sp in traces[0]["spans"]]
    finally:
        set_tracer(prev)
        node.close()
        shutil.rmtree(root, ignore_errors=True)
