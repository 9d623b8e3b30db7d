"""The port's metrics endpoint, latency observatory and profiler
(``metrics.py``, ``latency.py``, ``profiler.py``) against the agent's.

- ``AgentMetrics`` declares the same families: name, type and label set
  (a contract dashboards and fleet aggregation read).
- After one node's flow through ``tests/torch_agent_rig.py`` (Allocate
  and PreStart over the RPC methods, a health poll, GC of a deleted pod,
  a reconcile pass), the ported families' samples equal the agent's:
  values of counters and gauges, counts of histograms.
- ``lint_exposition`` gives the same verdicts on a good scrape and on
  broken texts.
- The endpoint's routes, filters, 400s, 404s and 503s (a debug surface
  not attached yet, ``/debug/allocations`` and ``/debug/goodput`` until
  a sampler or ledger comes), ``/healthz`` going 503 on a circuit-broken
  critical subsystem, and the loopback rule for ``/debug/*``, answered
  as the agent's server answers them.
- ``BoundedLabeledGauge`` evicts the least recently set series.
- The bind latency observatory: phases plus the residual equal each
  bind's total, innermost spans win, every populated bucket keeps an
  exemplar trace; the detection-lag tracker's marks, dedup and clamp.
- The profiler's stack table stays bounded; ``render_profile`` renders
  as the agent's.
"""

import io
import json
import os
import shutil
import tempfile
import threading
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")
pytest.importorskip("prometheus_client")

from prometheus_client import CollectorRegistry, Counter, Gauge  # noqa: E402
from prometheus_client import generate_latest  # noqa: E402
from prometheus_client.parser import text_string_to_metric_families  # noqa: E402

from elastic_tpu_agent import common as agent_common  # noqa: E402
from elastic_tpu_agent import latency as agent_latency  # noqa: E402
from elastic_tpu_agent import metrics as agent_metrics  # noqa: E402
from elastic_tpu_agent import profiler as agent_profiler  # noqa: E402
from elastic_tpu_agent.gen import deviceplugin_pb2 as agent_dp  # noqa: E402
from elastic_tpu_agent_torch import common, latency, metrics  # noqa: E402
from elastic_tpu_agent_torch import profiler  # noqa: E402
from elastic_tpu_agent_torch.gen import deviceplugin_pb2 as dp  # noqa: E402

from torch_agent_rig import UNITS, Node  # noqa: E402

SIDES = {"port": (metrics, latency, profiler, common, dp),
         "agent": (agent_metrics, agent_latency, agent_profiler,
                   agent_common, agent_dp)}


def declared(m) -> dict:
    """{family: (type, label names)} of every metric AgentMetrics holds."""
    out = {}
    for value in vars(m).values():
        inner = getattr(value, "_gauge", value)
        if hasattr(inner, "_labelnames") and hasattr(inner, "_type"):
            out[inner._name] = (inner._type, tuple(inner._labelnames))
    return out


def test_families_types_and_labels_equal_the_agents():
    port = declared(metrics.AgentMetrics(registry=CollectorRegistry()))
    agent = declared(agent_metrics.AgentMetrics(registry=CollectorRegistry()))
    assert port == agent
    assert len(port) >= 90
    assert port["elastic_tpu_reconcile_repairs"] == ("counter", ("kind",))
    assert port["elastic_tpu_detection_lag_seconds"] == (
        "histogram", ("loop", "stage", "trigger"))
    assert metrics.DEBUG_ROUTES == agent_metrics.DEBUG_ROUTES


# -- one node's flow -----------------------------------------------------------

PORTED = (
    "elastic_tpu_allocate_seconds", "elastic_tpu_prestart_seconds",
    "elastic_tpu_bind_inflight", "elastic_tpu_bind_lock_wait_seconds",
    "elastic_tpu_bound_allocations", "elastic_tpu_gc_reclaimed",
    "elastic_tpu_timeline_events", "elastic_tpu_reconcile_repairs",
    "elastic_tpu_reconcile_runs", "elastic_tpu_reconcile_duration_seconds",
    "elastic_tpu_bind_intents_open", "elastic_tpu_chips_healthy",
    "elastic_tpu_kubelet_list", "elastic_tpu_orphan_sweep_failures",
    "elastic_tpu_bind_phase_seconds",
)


def samples(registry) -> dict:
    out = {}
    for fam in text_string_to_metric_families(
            generate_latest(registry).decode()):
        if fam.name not in PORTED:
            continue
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def node_flow(port: bool) -> dict:
    side = SIDES["port" if port else "agent"]
    mmod, lmod, _, _, dpm = side
    registry = CollectorRegistry()
    m = mmod.AgentMetrics(registry=registry)
    obs = lmod.BindLatencyObservatory(metrics=m)
    root = tempfile.mkdtemp(prefix="mt", dir="/tmp")
    node = Node(root, port)
    from elastic_tpu_agent_torch.tracing import get_tracer as port_tracer
    from elastic_tpu_agent.tracing import get_tracer as agent_tracer
    tracer = (port_tracer if port else agent_tracer)()
    tracer.add_listener(obs.observe_trace)
    try:
        gen = node.boot(metrics=m, timeline=True)
        node.annotate("a", "2")
        node.annotate("b", "1")
        for kind, pod, chip, units in (("core", "a", 2, range(50)),
                                       ("mem", "a", 2, range(UNITS // 4)),
                                       ("core", "b", 1, range(25))):
            ids = node.ids(kind, chip, units)
            plugin = gen.plugin_of(kind)
            plugin.Allocate(dpm.AllocateRequest(container_requests=[
                dpm.ContainerAllocateRequest(devicesIDs=ids)]), None)
            node.kubelet.assign("default", pod, "main", node.res(kind), ids)
            plugin.PreStartContainer(
                dpm.PreStartContainerRequest(devicesIDs=ids), None)
        gen.plugin.health_once()
        node.sitter.remove_pod("default", "a")
        node.kubelet.unassign_pod("default", "a")
        gen.plugin.gc_once()
        gen.operator.create(0, "0badbeef-0")       # an orphan link
        gen.reconciler.reconcile_once(boot=True)
        return dict(samples=samples(registry), binds=obs.observed_total)
    finally:
        tracer.remove_listener(obs.observe_trace)
        node.close()
        shutil.rmtree(root, ignore_errors=True)


def test_flow_samples_equal_the_agents():
    port = node_flow(True)
    agent = node_flow(False)
    # the bind phases each observatory saw: the same phases were hit
    # (their counts), not the same durations
    assert port == agent
    s = port["samples"]
    assert s[("elastic_tpu_allocate_seconds_count", ())] == 3
    assert s[("elastic_tpu_prestart_seconds_count", ())] == 3
    assert s[("elastic_tpu_bound_allocations", ())] == 1
    assert s[("elastic_tpu_gc_reclaimed_total", ())] == 1
    assert s[("elastic_tpu_chips_healthy", ())] == 4
    assert s[("elastic_tpu_reconcile_repairs_total",
              (("kind", "orphan_link"),))] == 1
    assert port["binds"] == 3


# -- lint_exposition -----------------------------------------------------------

GOOD = None  # a real scrape, built in the test
BROKEN = [
    "elastic_tpu_x 1\n",                                   # no HELP/TYPE
    "# HELP a a\n# TYPE a gauge\na 1\na 2\n",               # duplicate series
    '# HELP a a\n# TYPE a gauge\na{l="x\\q"} 1\n',          # bad escape
    "# HELP a a\n# TYPE a gauge\n# TYPE a gauge\na 1\n",    # duplicate TYPE
    "# HELP a a\n# TYPE a nonsense\na 1\n",                 # bad type
    "# HELP 1a a\n# TYPE a gauge\na one\n",                 # bad name, value
    "# HELP a a\na 1\n# TYPE a gauge\n",                    # TYPE after sample
]


def test_lint_verdicts_equal_the_agents():
    registry = CollectorRegistry()
    m = metrics.AgentMetrics(registry=registry)
    m.observe_allocate(0.01)
    m.reconcile_repairs.labels(kind="orphan_link").inc()
    good = generate_latest(registry).decode()
    assert metrics.lint_exposition(good) == [] == \
        agent_metrics.lint_exposition(good)
    for text in BROKEN:
        verdict = metrics.lint_exposition(text)
        assert verdict and verdict == agent_metrics.lint_exposition(text)


# -- the endpoint --------------------------------------------------------------


class Supervisor:
    def __init__(self, failed):
        self.failed = failed

    def healthz(self):
        return {"subsystems": {"gc": "failed" if self.failed else "running"},
                "degraded": [], "critical_failed":
                    ["gc"] if self.failed else []}


REQUESTS = ["/debug", "/debug/", "/debug/allocations", "/debug/goodput",
            "/debug/timeline", "/debug/latency", "/debug/profile",
            "/debug/requests", "/debug/nope", "/nope",
            "/debug/traces?limit=x", "/debug/traces?limit=2&pod=ns/a",
            "/healthz"]
ATTACHED = ["/debug/timeline?pod=ns/a", "/debug/timeline?chip=x",
            "/debug/timeline?kind=bind_intent&limit=1",
            "/debug/latency?top=x", "/debug/latency?top=3",
            "/debug/profile?top=2", "/debug/requests?slo=nonsense",
            "/debug/requests?id=0", "/healthz"]


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def normalize(body):
    """Drop what differs by process: trace counts, boot ids, clocks."""
    if isinstance(body, dict):
        return {k: normalize(v) for k, v in body.items()
                if k not in ("traces_completed", "boot_id", "capacity",
                             "completed_total", "overhead_ratio",
                             "sitter_sync_age_s", "ts")}
    if isinstance(body, (list, tuple)):
        return [normalize(v) for v in body]
    return body


def endpoint_story(side, tmp):
    mmod, lmod, pmod, com, _ = SIDES[side]
    m = mmod.AgentMetrics(registry=CollectorRegistry())
    m.serve(0)
    store = None
    try:
        before = [(p, *get(m.http_port, p)) for p in REQUESTS]
        from elastic_tpu_agent import timeline as agent_tl
        from elastic_tpu_agent.storage import Storage as AgentStorage
        from elastic_tpu_agent.workloads import request_obs as agent_ro
        from elastic_tpu_agent_torch import timeline as port_tl
        from elastic_tpu_agent_torch.storage import Storage
        from elastic_tpu_agent_torch.workloads import request_obs as port_ro
        port = side == "port"
        store = (Storage if port else AgentStorage)(
            os.path.join(tmp, f"{side}.db"))
        tl = (port_tl if port else agent_tl).Timeline(
            store, node_name="n", clock=com.ManualClock(5.0))
        tl.emit("bind_intent", keys={"pod": "ns/a", "trace": "t"})
        tl.emit("bind_commit", keys={"pod": "ns/a", "trace": "t"})
        m.attach_timeline(tl)
        m.attach_latency(lmod.BindLatencyObservatory(),
                         lmod.DetectionLagTracker())
        m.attach_profiler(pmod.SamplingProfiler(hz=1.0))
        m.attach_requests((port_ro if port else agent_ro).RequestObservatory(
            clock=com.ManualClock()))
        m.attach_supervisor(Supervisor(False))
        after = [(p, *get(m.http_port, p)) for p in ATTACHED]
        m.attach_supervisor(Supervisor(True))
        failing = get(m.http_port, "/healthz")
        # the loopback rule, through the server's own handler
        handler = m._httpd.RequestHandlerClass
        remote = {}
        for path in ("/debug/traces", "/debug/timeline", "/metrics",
                     "/healthz"):
            for addr in ("10.1.2.3", "127.0.0.1"):
                h = handler.__new__(handler)
                h.client_address = (addr, 5555)
                h.path, h.command = path, "GET"
                h.request_version = h.requestline = "HTTP/1.1"
                h.wfile = io.BytesIO()
                h.server = m._httpd
                h.do_GET()
                remote[(path, addr)] = h.wfile.getvalue().split(b" ", 2)[1]
        return [normalize(x) for x in (before, after, failing)], remote
    finally:
        m.close()
        if store is not None:
            store.close()


def test_routes_filters_and_the_loopback_rule_match_the_agents(tmp_path):
    port, remote = endpoint_story("port", str(tmp_path))
    assert (port, remote) == endpoint_story("agent", str(tmp_path))
    before, after, failing = port
    codes = {p: c for p, c, _ in before}
    assert codes["/debug/allocations"] == codes["/debug/goodput"] == 503
    assert codes["/debug/timeline"] == 503 and codes["/debug/nope"] == 404
    assert codes["/debug/traces?limit=x"] == 400 and codes["/healthz"] == 200
    codes = {p: c for p, c, _ in after}
    assert codes["/debug/timeline?chip=x"] == 400
    assert [e["kind"] for e in after[0][2]["events"]] == ["bind_intent",
                                                           "bind_commit"]
    assert failing[0] == 503
    assert remote[("/debug/traces", "10.1.2.3")] == b"403"
    assert remote[("/metrics", "10.1.2.3")] == b"200"
    assert remote[("/debug/traces", "127.0.0.1")] == b"200"


# -- BoundedLabeledGauge -------------------------------------------------------


def gauge_story(mmod):
    registry = CollectorRegistry()
    evicted = Counter("evicted", "e", registry=registry)
    g = mmod.BoundedLabeledGauge(Gauge("g", "g", ["pod"], registry=registry),
                                 max_series=3, evicted=evicted)
    for pod in ("a", "b", "c", "a", "d", "e"):
        g.set(1.0, pod=pod)
    g.remove(pod="e")
    g.remove(pod="never")
    text = generate_latest(registry).decode()
    return g.series_count, sorted(
        line for line in text.splitlines() if line.startswith(("g{",
                                                               "evicted_total")))


def test_bounded_gauge_evicts_as_the_agents():
    port = gauge_story(metrics)
    assert port == gauge_story(agent_metrics)
    assert port == (2, ['evicted_total 2.0', 'g{pod="a"} 1.0',
                        'g{pod="d"} 1.0'])


# -- the latency observatory ---------------------------------------------------


class Span:
    def __init__(self, name, offset_s, duration_s):
        self.name, self.offset_s, self.duration_s = name, offset_s, duration_s


class Trace:
    def __init__(self, tid, total, spans, node="n", name="PreStartContainer",
                 error=None):
        self.trace_id, self.name, self.error = tid, name, error
        self.duration_s, self.start_ts = total, 100.0
        self.attrs = {"node": node, "pod": "ns/" + tid}
        self.spans = [Span(*s) for s in spans]


TRACES = [
    Trace("t1", 0.050, [("pod_lookup", 0.0, 0.004),
                        ("bind_lock_wait", 0.005, 0.001),
                        ("checkpoint", 0.010, 0.020),
                        ("storage_flush_wait", 0.012, 0.015),
                        ("write_alloc_spec", 0.031, 0.006),
                        ("sink_enqueue", 0.040, 0.002)]),
    Trace("t2", 0.200, [("materialize_nodes", 0.0, 0.150),
                        ("not_a_phase", 0.0, 0.190)]),
    Trace("t3", 0.010, [("checkpoint", 0.0, 0.004)], node="other"),
    Trace("t4", 0.010, [("checkpoint", 0.0, 0.004)], error="boom"),
    Trace("t5", 0.010, [], name="Allocate"),
]


def latency_story(lmod, com):
    obs = lmod.BindLatencyObservatory(node_name="n")
    for tr in TRACES:
        obs.observe_trace(tr)
    clock = com.ManualClock(1000.0)
    lag = lmod.DetectionLagTracker(clock=clock)
    lag.mark("reclaimed_pod", "ns/a")
    clock.advance(0.25)
    first = lag.handled("gc", "reclaimed_pod", key="ns/a", trigger="event")
    again = lag.handled("reconciler", "reclaimed_pod", key="ns/a")
    skew = lag.repaired("reconciler", "orphan_link", key="x",
                        origin_ts=clock.time() + 5)
    return obs.status(top=10), lag.status(), first, again, skew


def test_latency_observatory_and_lag_match_the_agents():
    port = latency_story(latency, common)
    assert port == latency_story(agent_latency, agent_common)
    status, lag, first, again, skew = port
    assert status["observed_total"] == 2       # t3: other node; t4, t5 out
    for b in status["slowest"]:
        assert abs(sum(b["phases_ms"].values()) + b["residual_ms"]
                   - b["total_ms"]) < 1e-6
    t1 = next(b for b in status["slowest"] if b["trace_id"] == "t1")
    # the checkpoint keeps only what storage_flush_wait left of it
    assert t1["phases_ms"] == {"kubelet_list": 4.0, "lock_wait": 1.0,
                               "sink_enqueue": 2.0, "spec_write": 6.0,
                               "storage_sync": 20.0}
    assert t1["residual_ms"] == 17.0
    for phase, block in status["phases"].items():
        if block["count"]:
            assert block["exemplars"], phase
    assert first == 0.25 and again is None and skew == 0.0
    assert lag["clamped_total"] == 1
    assert lag["classes"]["reclaimed_pod"]["triggers"] == {
        "event": {"count": 1, "p50_s": 0.25}}


# -- the profiler --------------------------------------------------------------


def test_profiler_stack_table_stays_bounded():
    stop = threading.Event()
    started = threading.Barrier(25)

    def nest(n):
        if n:
            return nest(n - 1)
        started.wait(10)
        stop.wait(10)

    threads = [threading.Thread(target=nest, args=(i,), name=f"w{i}")
               for i in range(24)]
    for t in threads:
        t.start()
    started.wait(10)
    try:
        prof = profiler.SamplingProfiler(hz=5.0, max_stacks=16, depth=3)
        for _ in range(3):
            prof.sample_once()
        st = prof.status(top=100)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert st["unique_stacks"] == 16 and st["dropped_stacks"] > 0
    assert all(len(e["stack"]) <= 3 for e in st["top"])
    assert st["samples_total"] == 3 and 0 <= st["overhead_ratio"] < 1
    payload = dict(st, overhead_ratio=0.00125)
    assert profiler.render_profile(payload, top=5) == \
        agent_profiler.render_profile(payload, top=5)
    assert profiler.render_profile({"enabled": False}).startswith(
        "profiler DISABLED")
