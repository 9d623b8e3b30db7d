"""The port's slice orchestration (``slice_env.py``, ``slices/registry.py``,
``slices/recovery.py``, the reconciler's slice passes and the plugins' slice
stamp) against the agent's, on the same pods and specs.

Each case runs once through the agent's modules and once through the
port's, with a side's own slice type where a type is read (the agent's
``v4-16`` is 2 hosts, as the port's ``h100-sxm5-16``; ``TYPES``), and the
two outcomes must be equal once each side's type strings read as their
host count. The world keys (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``ELASTIC_TPU_SLICE_NAME``, ``ELASTIC_TPU_SLICE_EPOCH``), reform epochs,
validation problems and reform work orders compare equal; the one stated
difference is the ICI grid: the agent stamps ``TPU_CHIPS_PER_HOST_BOUNDS``
and ``TPU_HOST_BOUNDS`` and the port stamps neither (``norm`` checks both
on every env it meets). Nothing here needs a card.
"""

import dataclasses
import json
import random
import shutil
import tempfile
import threading

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import reconciler as agent_reconciler  # noqa: E402
from elastic_tpu_agent import slice_env as agent_env  # noqa: E402
from elastic_tpu_agent import slices as agent_slices  # noqa: E402
from elastic_tpu_agent.tpu import topology as agent_topo  # noqa: E402
from elastic_tpu_agent_torch import reconciler  # noqa: E402
from elastic_tpu_agent_torch import slice_env  # noqa: E402
from elastic_tpu_agent_torch import slices  # noqa: E402
from elastic_tpu_agent_torch.common import (  # noqa: E402
    AnnotationDraining,
    AnnotationSliceID,
    AnnotationSliceName,
    AnnotationSliceWorkerHosts,
    AnnotationSliceWorkerID,
    EnvSliceEpoch,
    EnvSliceName,
)
from elastic_tpu_agent_torch.device import topology  # noqa: E402
from elastic_tpu_agent_torch.device.stub import H100_SXM5  # noqa: E402
from elastic_tpu_agent_torch.types import PodContainer  # noqa: E402

from torch_agent_rig import Node  # noqa: E402

ICI_KEYS = ("TPU_CHIPS_PER_HOST_BOUNDS", "TPU_HOST_BOUNDS")
WORLD_KEYS = ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", EnvSliceName,
              EnvSliceEpoch)
# a slice type of n hosts, each side's
TYPES = {True: {1: "h100-sxm5-8", 2: "h100-sxm5-16", 3: "h100-sxm5-24",
                4: "h100-sxm5-32"},
         False: {1: "v4-8", 2: "v4-16", 3: "v4-24", 4: "v4-32"}}
# the host's own topology when no slice type is annotated: the agent's
# TPU-VM types, the port's card product
HOST_TYPES = {True: (H100_SXM5,), False: ("v5litepod-4", "v5p-16",
                                          "v5p-32")}


class Side:
    """One package's slice modules."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.env = slice_env if port else agent_env
        self.slices = slices if port else agent_slices
        self.reconciler = reconciler if port else agent_reconciler
        self.parse = (topology if port else agent_topo).parse_accelerator_type
        self.types = TYPES[port]

    def topo(self, hosts: int):
        return self.parse(self.types[hosts])

    def host_topo(self, hosts: int):
        """This host's topology in a world of ``hosts`` (no annotation)."""
        if self.port:
            return topology.host_topology(H100_SXM5, 8, hosts)
        return self.parse({1: "v5litepod-4", 2: "v5p-16", 4: "v5p-32"}[hosts])

    def registry(self, kube=None, ttl=0.0, **kw):
        return self.slices.SliceRegistry(
            node_name="host-a", kube_client=kube, membership_ttl_s=ttl, **kw)


SIDES = (Side(True), Side(False))


def norm(side: Side, obj):
    """``obj`` JSON-able, the side's type strings as their host count
    (a host topology's as ``<host>``), and every slice env checked for the
    ICI keys (the agent's carry both, the port's neither) and stripped of
    them."""
    names = {t: f"<{n} hosts>" for n, t in side.types.items()}
    names.update({t: "<host>" for t in HOST_TYPES[side.port]})

    def walk(x):
        if isinstance(x, dict):
            if "TPU_WORKER_ID" in x and "TPU_ACCELERATOR_TYPE" in x:
                have = [k in x for k in ICI_KEYS]
                assert have == [not side.port] * 2, (side.port, x)
            return {k: walk(v) for k, v in x.items() if k not in ICI_KEYS}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        if isinstance(x, str):
            return names.get(x, x)
        return x

    return walk(json.loads(json.dumps(obj, default=_plain)))


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, set):
        return sorted(x)
    raise TypeError(type(x))


def both(case, *args):
    """``case(side, *args)`` on each side; the normalized outcomes must be
    equal. Returns the port's, normalized."""
    port, agent = (norm(s, case(s, *args)) for s in SIDES)
    assert port == agent
    return port


def member_pod(slice_id, name, host, wid, hosts, node="n", deleted=False,
               phase=None, draining=False):
    meta = {"namespace": "ml", "name": name, "annotations": {
        AnnotationSliceID: slice_id, AnnotationSliceWorkerID: str(wid),
        AnnotationSliceWorkerHosts: ",".join(hosts)}}
    if deleted:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    if draining:
        meta["annotations"][AnnotationDraining] = "true"
    pod = {"metadata": meta, "spec": {"nodeName": node}}
    if phase:
        pod["status"] = {"phase": phase}
    return pod


class FakeKube:
    """``list_all_pods`` over a mutable pod list, its calls counted."""

    def __init__(self, pods=None):
        self.pods = list(pods or [])
        self.calls = 0
        self.fail = False

    def list_all_pods(self):
        self.calls += 1
        if self.fail:
            raise RuntimeError("apiserver down")
        return json.loads(json.dumps(self.pods))


def annotations(side, slice_id, wid, hosts, n_type=None):
    ann = {AnnotationSliceID: slice_id, AnnotationSliceWorkerID: str(wid),
           AnnotationSliceWorkerHosts: ",".join(hosts)}
    if n_type:
        ann[AnnotationSliceName] = side.types[n_type]
    return ann


# -- the slice env: parse and order -------------------------------------------


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_slice_types_parse_and_resize_as_the_agents(hosts):
    def case(side, n):
        topo = side.topo(n)
        resized = (topology if side.port else agent_topo).topology_for_hosts(
            topo, 1)
        return dict(hosts=topo.num_hosts, multi=topo.is_multi_host,
                    type=topo.accelerator_type, resized=resized.num_hosts,
                    kept=resized.accelerator_type,
                    per_host_kept=(resized.chips_per_host
                                   == topo.chips_per_host))

    got = both(case, hosts)
    assert got["hosts"] == hosts and got["resized"] == 1
    assert got["type"] == got["kept"] == f"<{hosts} hosts>"
    assert topology.parse_accelerator_type("h100-sxm5-16").chips_per_host == 8
    for bad in ("v4-16", "h100-sxm5", "h100-sxm5-0", "", "nvidia-8"):
        assert topology.parse_accelerator_type(bad) is None


MEMBER_PODS = [
    member_pod("s", "m1", "host-b", 0, ["host-b", "host-a"]),
    member_pod("s", "m2", "x", 5, ["x", "y"]),           # id out of range
    member_pod("s", "m3", "x", 0, []),                   # no hosts
    {"metadata": {}},
    {"metadata": {"annotations": {AnnotationSliceID: "s",
                                  AnnotationSliceWorkerID: "one",
                                  AnnotationSliceWorkerHosts: "a,b"}}},
    member_pod("s", "m4", "host-c", 2, ["host-c", "host-a", "host-c",
                                        "host-b", ""]),  # duplicates
]


@pytest.mark.parametrize("i", range(len(MEMBER_PODS)))
def test_member_parse_matches_the_agents(i):
    got = both(lambda side: side.slices.member_from_pod(MEMBER_PODS[i]))
    if i == 0:
        assert got["hosts"] == ["host-a", "host-b"] and got["worker_id"] == 1


@pytest.mark.parametrize("seed", range(4))
def test_worker_order_is_a_function_of_the_host_set(seed):
    def case(side):
        rng = random.Random(seed)
        hosts = [f"host-{rng.randrange(1000)}-{i}"
                 for i in range(rng.randint(2, 6))]
        out = []
        for _ in range(8):
            shuffled = list(hosts)
            rng.shuffle(shuffled)
            own = rng.choice(hosts)
            out.append(side.env.ordered_worker_hostnames(shuffled + hosts,
                                                         own))
        out.append(side.env.ordered_worker_hostnames(hosts, "nope"))
        return out

    got = both(case)
    assert len({tuple(o[0]) for o in got}) == 1
    assert got[-1][1] == -1


ENV_CASES = {
    "single host, no annotation": ({}, 1),
    "host facts of a 2-host world": ({}, 2),
    "annotated type only": ({"type": 2}, 1),
    "annotated id and hosts": ({"type": 2, "wid": "1",
                                "hosts": "h1,h0"}, 1),
    "hosts without a type": ({"wid": "0", "hosts": "h0,h1"}, 2),
    "id that is not a number": ({"type": 4, "wid": "x",
                                 "hosts": "a,b,c,d"}, 4),
    "unknown type": ({"type": "bogus-4", "wid": "0", "hosts": "a"}, 1),
}


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_slice_env_for_pod_matches_the_agents(name):
    spec, host_n = ENV_CASES[name]

    def case(side):
        ann = {}
        if "type" in spec:
            t = spec["type"]
            ann[AnnotationSliceName] = (side.types[t] if isinstance(t, int)
                                        else t)
        if "wid" in spec:
            ann[AnnotationSliceWorkerID] = spec["wid"]
        if "hosts" in spec:
            ann[AnnotationSliceWorkerHosts] = spec["hosts"]
        hosts = [f"h{i}" for i in range(host_n)] if host_n > 1 else []
        return side.env.slice_env_for_pod(ann, side.host_topo(host_n), 1
                                          if host_n > 1 else 0, hosts)

    got = both(case)
    if name == "annotated id and hosts":
        assert got == {"TPU_ACCELERATOR_TYPE": "<2 hosts>",
                       "TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h1,h0"}
    if name == "single host, no annotation":
        assert got == {}


def test_ici_bound_keys_are_the_one_stated_difference():
    """The agent's env carries the ICI grid, the port's does not; every
    other key is the same on the same inputs."""
    envs = {}
    for side in SIDES:
        reg = side.registry()
        envs[side.port] = reg.pod_env(
            annotations(side, "job", 1, ["h1", "h0"], n_type=2), None)
    assert set(envs[False]) - set(envs[True]) == set(ICI_KEYS)
    assert set(envs[True]) <= set(envs[False])
    assert {k: envs[True][k] for k in WORLD_KEYS} == {
        k: envs[False][k] for k in WORLD_KEYS} == {
        "TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "h0,h1",
        EnvSliceName: "job", EnvSliceEpoch: "0"}
    assert envs[True]["TPU_ACCELERATOR_TYPE"] == "h100-sxm5-16"


# -- the registry: membership, validation, epochs -----------------------------


def membership_case(side):
    hosts = ["host-a", "host-b"]
    failed = member_pod("s1", "f", "host-b", 1, hosts, phase="Failed")
    kube = FakeKube([
        member_pod("s1", "m0", "host-a", 0, hosts),
        member_pod("s1", "m1", "host-b", 1, hosts),
        member_pod("s1", "gone", "host-b", 1, hosts, deleted=True),
        failed,
        member_pod("s1", "done", "host-a", 0, hosts, phase="Succeeded"),
        member_pod("s1", "drn", "host-b", 1, hosts, draining=True),
        member_pod("other", "x", "host-a", 0, hosts),
    ])
    reg = side.registry(kube, ttl=60.0)
    out = {"members": reg.live_members("s1"),
           "hosts": reg.live_hosts("s1"), "other": reg.live_hosts("other")}
    reg.live_members("s1")
    out["calls_in_ttl"] = kube.calls
    reg.live_members("s1", refresh=True)
    out["calls_refreshed"] = kube.calls
    reg.note_reform("s1", tuple(hosts))   # a slice state to carry errors
    kube.fail = True
    try:
        reg.live_members("s1", refresh=True)
        out["unknown"] = "answered"
    except side.slices.SliceMembershipError as e:
        out["unknown"] = str(e)
    out["last_error"] = reg.status()["s1"]["last_error"]
    # an unanswerable apiserver is never cached: the old snapshot serves
    # inside its TTL, a refresh fails again
    out["stale_after_failure"] = reg.live_hosts("s1")
    kube.fail = False
    out["recovered"] = reg.live_hosts("s1", refresh=True)
    out["error_cleared"] = reg.status()["s1"]["last_error"]
    kube.pods.remove(failed)
    failed["status"]["phase"] = "Running"
    kube.pods.append(failed)
    out["running_again"] = [m.pod_key for m in reg.live_members(
        "s1", refresh=True)]
    try:
        side.registry().live_members("s1")
    except side.slices.SliceMembershipError as e:
        out["no_client"] = str(e)
    out["calls"] = kube.calls
    return out


def test_membership_ttl_unknown_terminal_and_draining_match_the_agents():
    got = both(membership_case)
    assert [m["pod_key"] for m in got["members"]] == ["ml/m0", "ml/m1"]
    assert got["calls_in_ttl"] == 1 and got["calls_refreshed"] == 2
    assert "apiserver down" in got["unknown"]
    assert got["last_error"] and not got["error_cleared"]
    assert got["running_again"] == ["ml/m0", "ml/f", "ml/m1"]


def single_flight_case(side):
    started, release = threading.Event(), threading.Event()

    class SlowKube(FakeKube):
        def list_all_pods(self):
            started.set()
            release.wait(timeout=10.0)
            return super().list_all_pods()

    kube = SlowKube([member_pod("s1", "m0", "host-a", 0, ["host-a"]),
                     member_pod("s2", "x0", "host-b", 0, ["host-b"])])
    reg = side.registry(kube, ttl=60.0)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(reg.live_hosts("s1")))
        for _ in range(4)]
    threads[0].start()
    assert started.wait(timeout=5.0)
    for t in threads[1:]:
        t.start()
    release.set()
    for t in threads:
        t.join(timeout=10.0)
    # one LIST serves every slice for the TTL
    other = reg.live_hosts("s2")
    # the bind path's stale_ok rides any snapshot, even past the TTL
    reg._members_snapshot = (reg._members_snapshot[0] - 120.0,
                             reg._members_snapshot[1])
    stale = reg.live_members("s1", stale_ok=True)
    return dict(results=results, other=other, stale=len(stale),
                calls=kube.calls)


def test_single_flight_and_one_list_for_all_slices_match_the_agents():
    got = both(single_flight_case)
    assert got["results"] == [["host-a"]] * 4
    assert got["calls"] == 1 and got["other"] == ["host-b"]


VALIDATION = {
    "consistent": [("m0", "host-a", 0, ["host-a", "host-b"]),
                   ("m1", "host-b", 1, ["host-a", "host-b"])],
    "torn hosts": [("m0", "host-a", 0, ["host-a", "host-b"]),
                   ("m1", "host-b", 1, ["host-b", "host-z"])],
    "one id on two hosts": [("m0", "host-a", 0, ["host-a", "host-b"]),
                            ("m1", "host-b", 0, ["host-b"])],
    "two pods in one slot": [("m0", "host-a", 0, ["host-a", "host-b"]),
                             ("m0b", "host-a", 0, ["host-a", "host-b"]),
                             ("m1", "host-b", 1, ["host-a", "host-b"])],
    "unknown membership": None,
}


@pytest.mark.parametrize("name", sorted(VALIDATION))
def test_validation_problems_match_the_agents(name):
    def case(side):
        pods = VALIDATION[name]
        kube = FakeKube([member_pod("s1", n, h, w, hs)
                         for n, h, w, hs in pods or []])
        kube.fail = pods is None
        reg = side.registry(kube)
        return reg.validate_members("s1", ("host-a", "host-b"))

    got = both(case)
    assert bool(got) == (name not in ("consistent", "unknown membership"))


def epochs_case(side):
    reg = side.registry()
    out = [reg.epoch("s"), reg.note_reform("s", ("a", "b", "c")),
           reg.note_reform("s", ("a", "b", "c")),    # same world: same epoch
           reg.note_reform("s", ("a", "b")), reg.current_hosts("s"),
           reg.status()]
    reg.record_local_pod("s", "ml/p", 1)
    reg.record_local_pod("s", "ml/q", 0)
    reg.drop_local_pod("s", "ml/q")
    out.append(reg.status())
    reg.prune({"s"})
    out.append(sorted(reg.status()))
    reg.prune(set())
    out.append(reg.status())
    return out


def test_note_reform_epochs_and_prune_match_the_agents():
    got = both(epochs_case)
    assert got[:4] == [0, 1, 1, 2]
    assert got[5]["s"]["reforms_total"] == 2 and got[-1] == {}


def pod_env_case(side):
    hosts = ["host-a", "host-b", "host-c", "host-d"]
    ann = annotations(side, "job", 0, hosts, n_type=4)
    out = {}
    reg = side.registry()
    out["formed"] = reg.pod_env(ann, None)
    reg.note_reform("job", ("host-a", "host-b", "host-c"))
    out["override"] = reg.pod_env(ann, None)   # stale annotations
    # the prune race: a reconciler prune while pod_env validates
    racing = side.registry()
    validate = racing.validate_members

    def prune_then_validate(slice_id, h):
        racing.prune(set())
        return validate(slice_id, h)

    racing.validate_members = prune_then_validate
    out["raced"] = racing.pod_env(ann, None)
    out["raced_status"] = racing.status()
    # a restarted agent re-learns the stamp; an older stamp never regresses
    fresh = side.registry()
    fresh.observe_stamped("job", ("host-a", "host-b", "host-c"), 1,
                          accelerator_type=side.types[4])
    out["relearned"] = fresh.pod_env(ann, None)
    fresh.observe_stamped("job", tuple(hosts), 0)
    out["no_regress"] = (fresh.epoch("job"), fresh.current_hosts("job"))
    # an unusable claim falls back to the annotation order
    out["unusable"] = side.registry().pod_env(
        annotations(side, "bad", 7, ["x", "y"], n_type=2), None)
    out["no_slice_id"] = side.registry().pod_env(
        {AnnotationSliceName: side.types[2], AnnotationSliceWorkerID: "1",
         AnnotationSliceWorkerHosts: "b,a"}, None)
    out["host_facts"] = side.registry().pod_env(
        {AnnotationSliceID: "hf"}, side.host_topo(2), 1, ["h0", "h1"])
    return out


def test_reform_override_prune_race_and_observe_stamped_match_the_agents():
    got = both(pod_env_case)
    assert got["formed"]["TPU_WORKER_HOSTNAMES"] == (
        "host-a,host-b,host-c,host-d")
    assert (got["override"]["TPU_WORKER_HOSTNAMES"],
            got["override"][EnvSliceEpoch]) == ("host-a,host-b,host-c", "1")
    assert got["raced_status"]["job"]["epoch"] == 0
    assert got["relearned"][EnvSliceEpoch] == "1"
    assert got["no_regress"] == [1, ["host-a", "host-b", "host-c"]]


# -- the reformer: divergence orders and reforms ------------------------------


class FakeRecord:
    def __init__(self, h):
        self.device = type("D", (), {"hash": h})()


class FakeCore:
    """The specs of one container, in memory."""

    def __init__(self, specs):
        self.specs = specs

    def read_alloc_spec(self, h):
        spec = self.specs.get(h)
        return json.loads(json.dumps(spec)) if spec is not None else None

    def restamp_spec_env_locked(self, owner, records, env_updates,
                                remove_keys=()):
        for h in records:
            if h in self.specs:
                self.specs[h]["env"].update(env_updates)
        return sum(h in self.specs for h in records)


class Log:
    """An Event recorder and a timeline in one: what each was given."""

    def __init__(self):
        self.posted = []

    def pod_event(self, namespace, name, reason, message, type_="Normal",
                  **kw):
        self.posted.append(("event", f"{namespace}/{name}", reason, message))

    def node_event(self, reason, message, type_="Normal", **kw):
        self.posted.append(("event", "node", reason, message))

    def emit(self, kind, keys=None, **attrs):
        self.posted.append(("timeline", kind, keys, attrs))


def stamp(side, hosts, wid, epoch, n_type=None):
    env = side.env.slice_env_from_topology(
        side.topo(n_type or max(1, len(hosts))), wid, hosts)
    env.update({EnvSliceName: "job", EnvSliceEpoch: str(epoch)})
    return {"env": env}


class Member:
    """One container of slice "job" on host-a, its specs in a FakeCore."""

    def __init__(self, side, hosts, live, specs=None, own="host-a"):
        self.side = side
        self.kube = FakeKube([member_pod("job", f"m-{h}", h, i, sorted(live))
                              for i, h in enumerate(sorted(live))])
        self.core = FakeCore(specs or {"a": stamp(
            side, hosts, sorted(hosts).index(own), 0, n_type=len(hosts))})
        self.log = Log()
        self.registry = side.registry(self.kube, events=self.log)
        self.reformer = side.slices.SliceReformer(
            self.registry, type("P", (), {"core": self.core})(),
            events=self.log, timeline=self.log)
        self.records = {h: FakeRecord(h) for h in self.core.specs}
        self.owner = PodContainer("ml", "m0", "jax")

    def live(self, hosts):
        self.kube.pods = [member_pod("job", f"m-{h}", h, i, sorted(hosts))
                          for i, h in enumerate(sorted(hosts))]

    def divergence(self):
        return self.reformer.divergence(self.owner, self.records)

    def reform(self, div):
        return self.reformer.reform(self.owner, self.records, div)

    def env(self, h="a"):
        return self.core.specs[h]["env"]


def loss_and_return(side):
    m = Member(side, ["host-a", "host-b"], ["host-a", "host-b"])
    out = [m.divergence()]
    m.live(["host-a"])
    div = m.divergence()
    out += [div, m.reform(div), dict(m.env()), m.divergence()]
    m.live(["host-a", "host-c"])               # a replacement joins
    div = m.divergence()
    out += [div, m.reform(div), dict(m.env()), m.log.posted,
            m.registry.status()]
    return out


def torn(side):
    m = Member(side, ["host-a"], ["host-a"], specs={
        "a": stamp(side, ["host-a"], 0, 1, n_type=2),      # reformed
        "b": stamp(side, ["host-a", "host-b"], 0, 0)})    # not yet
    div = m.divergence()
    return [div, m.reform(div), m.core.specs, m.divergence()]


def grow_back_order(side):
    """A survivor on host-c; the joiner on host-a sorts first."""
    m = Member(side, ["host-b", "host-c"], ["host-b", "host-c"],
               own="host-c")
    m.live(["host-c"])
    out = [m.reform(m.divergence())]
    m.live(["host-a", "host-c"])
    div = m.divergence()
    out += [div, m.reform(div), dict(m.env()), m.divergence()]
    return out


def own_invisible(side):
    m = Member(side, ["host-a", "host-b"], [])
    return m.divergence()


def unknown(side):
    m = Member(side, ["host-a", "host-b"], ["host-a"])
    m.kube.fail = True
    try:
        m.divergence()
    except side.slices.SliceMembershipError as e:
        return f"unknown: {e}"
    return "answered"


def non_canonical(side):
    m = Member(side, ["host-a", "host-b"], ["host-a", "host-b"], specs={
        "a": stamp(side, ["host-b", "host-a"], 1, 3, n_type=2)})
    div = m.divergence()
    return [div, m.reform(div), dict(m.env())]


def malformed(side):
    return Member(side, ["host-a", "host-b"], ["host-a"], specs={
        "a": stamp(side, ["host-a", "host-b"], 5, 0)}).divergence()


def vanished_specs(side):
    m = Member(side, ["host-a", "host-b"], ["host-a"])
    div = m.divergence()
    m.core.specs.clear()
    try:
        m.reform(div)
    except RuntimeError as e:
        return str(e)
    return "reformed"


DIVERGENCE = {f.__name__: f for f in (
    loss_and_return, torn, grow_back_order, own_invisible, unknown,
    non_canonical, malformed, vanished_specs)}


@pytest.mark.parametrize("name", sorted(DIVERGENCE))
def test_divergence_orders_and_reforms_match_the_agents(name):
    got = both(DIVERGENCE[name])
    if name == "loss_and_return":
        assert got[0] is None and got[1]["lost"] == ["host-b"]
        assert got[2] == 1 and got[3]["TPU_WORKER_HOSTNAMES"] == "host-a"
        assert got[4] is None and got[5]["joined"] == ["host-c"]
        assert got[6] == 2 and got[7][EnvSliceEpoch] == "2"
        reasons = [p[2] for p in got[8] if p[0] == "event"]
        kinds = [p[1] for p in got[8] if p[0] == "timeline"]
        assert reasons == ["TPUSliceReformed"] * 2
        assert kinds == ["slice_reformed"] * 2
    if name == "torn":
        assert got[0]["torn"] and got[1] == 1 and got[3] is None
    if name == "grow_back_order":
        assert got[1]["new_hosts"] == ["host-a", "host-c"]
        assert got[1]["new_worker_id"] == 1 and got[4] is None
    if name in ("own_invisible", "malformed"):
        assert got is None
    if name == "unknown":
        assert got.startswith("unknown")


# -- the reconciler's slice passes --------------------------------------------


class FakeStore:
    """The store's reads the slice passes make, over one pod's records."""

    def __init__(self, records):
        info = type("I", (), {})()
        info.namespace, info.name, info.key = "ml", "m0", "ml/m0"
        info.allocations = {"jax": records}
        self.info = info

    def items(self):
        return [("ml/m0", self.info)]

    def load(self, namespace, name):
        return self.info if (namespace, name) == ("ml", "m0") else None


class Sitter:
    def __init__(self):
        self.pod = {"metadata": {"namespace": "ml", "name": "m0",
                                 "annotations": {AnnotationSliceID: "job"}}}

    def get_pod(self, namespace, name):
        return self.pod if (namespace, name) == ("ml", "m0") else None


def passes_case(side):
    """Two sightings, the second from a fresh LIST, with a TTL longer than
    the passes; an unknowable membership; the boot pre-learn and the
    restart-safe epoch."""
    m = Member(side, ["host-a", "host-b"], ["host-a", "host-b"])
    m.registry._ttl = 60.0
    rec = side.reconciler.Reconciler(
        FakeStore(m.records), None, type("P", (), {"core": m.core})(),
        Sitter(), slice_reformer=m.reformer)

    def one_pass(boot=False):
        report = dict(slice_check_errors=0, slice_reform_failures=0,
                      divergences_observed=0, slice_reforms=0)
        rec._reconcile_slices(report, boot, True)
        rec._prev_candidates, rec._tick_candidates = (
            rec._tick_candidates, set())
        return dict(report, lists=m.kube.calls,
                    epoch=m.env()[EnvSliceEpoch])

    out = [one_pass()]
    m.live(["host-a"])
    out.append(one_pass())          # the cached snapshot: still world 2
    m.registry._members_snapshot = None
    out.append(one_pass())          # first sighting of the loss
    out.append(one_pass())          # confirmed by a fresh LIST: reformed
    m.kube.fail = True
    m.registry._members_snapshot = None
    out.append(one_pass())          # unknowable: never a loss
    m.kube.fail = False
    # a restarted agent: a cold registry, the same specs
    fresh = side.registry(m.kube)
    rec2 = side.reconciler.Reconciler(
        FakeStore(m.records), None, type("P", (), {"core": m.core})(),
        Sitter(), slice_reformer=side.slices.SliceReformer(
            fresh, type("P", (), {"core": m.core})()))
    rec2._prelearn_slices()
    out.append((fresh.epoch("job"), fresh.current_hosts("job")))
    out.append(fresh.pod_env(
        annotations(side, "job", 0, ["host-a", "host-b"], n_type=2), None))
    m.live(["host-a", "host-b"])    # the member returns: epoch 2, not 1
    div = rec2._slices.divergence(PodContainer("ml", "m0", "jax"),
                                  m.records)
    out.append(rec2._slices.reform(PodContainer("ml", "m0", "jax"),
                                   m.records, div))
    out.append(rec2.status()["slice_reform_failures_total"])
    return out


def test_reconciler_slice_passes_match_the_agents():
    got = both(passes_case)
    assert [p["slice_reforms"] for p in got[:4]] == [0, 0, 0, 1]
    # the confirming sighting made its own LIST
    assert got[3]["lists"] == got[2]["lists"] + 1
    assert got[3]["epoch"] == "1"
    assert got[4]["slice_check_errors"] == 1 and got[4]["epoch"] == "1"
    assert got[5] == [1, ["host-a"]]
    assert got[6]["TPU_WORKER_HOSTNAMES"] == "host-a"
    assert got[7] == 2


# -- the bind path: the plugins stamp through the registry --------------------


def bind_path_case(side):
    """A slice member bound through the side's plugins (the rig's node
    with a SliceRegistry), then re-formed by two reconcile passes."""
    from prometheus_client import CollectorRegistry

    from elastic_tpu_agent import metrics as agent_metrics
    from elastic_tpu_agent_torch import metrics as port_metrics

    root = tempfile.mkdtemp(prefix="sl", dir="/tmp")
    node = Node(root, side.port)
    try:
        hosts = ["host-b", "host-a"]
        kube = FakeKube([member_pod("job", "p", "host-a", 1, hosts),
                         member_pod("job", "q", "host-b", 0, hosts)])
        registry = CollectorRegistry()
        metrics = (port_metrics if side.port else agent_metrics
                   ).AgentMetrics(registry=registry)
        gen = node.boot(slice_kube=kube, timeline=True, metrics=metrics)
        node.annotate("p", "2")
        node.sitter.pods[("default", "p")]["metadata"]["annotations"].update(
            annotations(side, "job", 1, hosts, n_type=2))
        h = node.bind("core", "p", 2, range(50))
        env = gen.plugin.core.read_alloc_spec(h)["env"]
        formed = [(r["kind"], r["keys"].get("slice"), r["attrs"])
                  for r in gen.storage.timeline_rows()
                  if r["kind"] in ("slice_formed", "bind_commit")]
        status = gen.slices.status()
        first = gen.reconciler.reconcile_once()
        kube.pods = kube.pods[:1]                  # host-b goes
        reports = [gen.reconciler.reconcile_once() for _ in range(2)]
        reformed = gen.plugin.core.read_alloc_spec(h)["env"]
        samples = {s.name: s.value for fam in registry.collect()
                   for s in fam.samples
                   if s.name.startswith(("elastic_tpu_slice",
                                         "elastic_tpu_packing_ici_span_count"))
                   and not s.name.endswith("_created")}
        keys = ("slice_reforms", "slice_check_errors",
                "slice_reform_failures", "pending_confirmation")
        return dict(
            env={k: env[k] for k in env if k.startswith(("TPU_W", "TPU_A",
                                                         "ELASTIC_TPU_S"))
                 or k in ICI_KEYS},
            formed=[(k, s, {a: v for a, v in at.items()
                            if a in ("epoch", "worker_id", "hosts")})
                    for k, s, at in formed],
            status=status,
            reports=[{k: r[k] for k in keys} for r in [first] + reports],
            reformed={k: reformed[k] for k in reformed
                      if k.startswith(("TPU_W", "TPU_A", "ELASTIC_TPU_S"))
                      or k in ICI_KEYS},
            samples=samples)
    finally:
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def test_the_plugins_stamp_and_the_reconciler_reforms_as_the_agents():
    got = both(bind_path_case)
    assert got["env"]["TPU_WORKER_HOSTNAMES"] == "host-a,host-b"
    assert got["env"]["TPU_WORKER_ID"] == "0"
    assert got["formed"][0][:2] == ["slice_formed", "job"]
    assert got["formed"][1][:2] == ["bind_commit", "job"]
    assert got["status"]["job"]["validation_problems"] == []
    assert [r["slice_reforms"] for r in got["reports"]] == [0, 0, 1]
    assert got["reformed"]["TPU_WORKER_HOSTNAMES"] == "host-a"
    assert got["reformed"][EnvSliceEpoch] == "1"
    assert got["samples"]["elastic_tpu_packing_ici_span_count"] == 1.0
