"""The readers of the program's phase spans (``harness/program_spans.py``
and the metrics that use it) on hand-built runs, traces and span logs;
on the card, that the program's spans and CUPTI's launch times share one
clock, and that the program's ``serving.step`` spans take the same device
operations as the benchmark's own ``step`` spans
(``python -m pytest -m cuda benchmark/tests``; skips without a card)."""

import time

import pytest

from benchmark.harness import program_spans, spec
from benchmark.harness.record import Run, Span
from benchmark.harness.trace import DeviceTrace
from elastic_tpu_agent_torch.workloads import telemetry

US = 1_000
T = 1_790_000_000_000_000_000     # a wall-clock origin in ns


class FakeLog:
    """The program's span log as the readers see it."""

    def __init__(self, spans, written=None, capacity=1 << 16):
        self.entries = [(n, T + a * US, T + b * US, tuple(c.items()))
                        for n, a, b, c in spans]
        self.capacity = capacity
        self.written = len(spans) if written is None else written

    def read(self):
        return self.written, list(self.entries)


def _phases(parent, t0, t1, cuts, names, **counters):
    """A parent span and its children, which tile it at ``cuts``."""
    edges = [t0, *cuts, t1]
    return [(parent, t0, t1, counters)] + [
        (f"{parent}.{n}", a, b, {}) for n, a, b in zip(names, edges,
                                                         edges[1:])]


STEP = ("prepare", "forward", "sync", "bookkeep")
ADMIT = ("claim", "forward", "sample", "finish")
# times in µs from T; the window is [0, 10000], the trace [5000, 10000]
SERVE_SPANS = (
    _phases("serving.admit", 100, 1100, (150, 900, 1050), ADMIT,
            live_rows=2)
    + _phases("serving.step", 1200, 2200, (1300, 2000, 2150), STEP,
              live_rows=3)
    + _phases("serving.step", 2300, 2900, (2350, 2800, 2880), STEP,
              live_rows=3)
    + _phases("serving.step", 6000, 7000, (6100, 6800, 6900), STEP,
              live_rows=4)
    + _phases("serving.admit", 7500, 9000, (7600, 8500, 8900), ADMIT,
              live_rows=4))
# (name, launched at, start, end) in µs; correlation ids count from 1
SERVE_OPS = [("gemm", 6150, 6200, 6300), ("paged_split_kernel", 6500, 6600,
                                                                   6900),
             ("Memcpy DtoH", 6850, 6950, 6960), ("softmax", 7700, 7800, 8800),
             ("fill", 9500, 9600, 9700)]


def _trace(ops, t0=5000, t1=10000):
    return DeviceTrace(T + t0 * US, T + t1 * US,
                       [(n, T + a * US, T + b * US, i)
                        for i, (n, _, a, b) in enumerate(ops, 1)],
                       {i: T + at * US for i, (_, at, _, _) in
                        enumerate(ops, 1)})


def _run(cell, ops, traced=True):
    run = Run(cell, spec.load_cell(cell), {}, {}, 1, 0.01, traced)
    run.window = (T, T + 10000 * US)
    run.trace = _trace(ops) if traced else None
    return run


def _read(name, run):
    return spec.metric_reader(name).read(run)


@pytest.fixture
def serve(monkeypatch):
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(SERVE_SPANS))
    return _run("starcoder2-3b.complete", SERVE_OPS)


@pytest.mark.parametrize("name,want", [
    # the untraced part's two steps: forward 700 and 450 µs
    ("decode_launch_ms.complete", 0.575),
    # prepare + bookkeep: 100 + 50 and 50 + 20 µs
    ("decode_prepare_ms.complete", 0.110),
    # admit 1000 µs x 2 rows against steps (1000 + 600) µs x 3 rows
    ("decode_stall_share.complete", 100 * 2000 / 6800),
    # the traced step launched three ops of 100, 300 and 10 µs
    ("decode_device_ms.complete", 0.410),
    ("decode_launches.complete", 3.0),
    ("prefill_device_ms.complete", 1.0),
    # idle under a forward span: 100 + 300 µs in the step, 200 in the
    # admission, of a 5000 µs trace
    ("launch_bound_idle.complete", 12.0),
])
def test_serving_readers_on_a_hand_built_run(serve, name, want):
    assert _read(name, serve) == pytest.approx(want)


def test_launch_bound_idle_is_a_part_of_device_idle(serve):
    idle = _read("device_idle.complete", serve)
    assert idle == pytest.approx(100 * 3490 / 5000)
    assert _read("launch_bound_idle.complete", serve) <= idle


TRAIN_SPANS = [
    ("train.step", a, a + 1900, {}) for a in (5100, 7100)
] + [(f"train.{n}", a + o, a + e, {})
     for a in (5100, 7100)
     for n, o, e in (("forward", 0, 700), ("backward", 700, 1600),
                     ("optimizer", 1600, 1900))]
TRAIN_OPS = [("fwd", 5200, 5300, 5700), ("bwd", 5900, 6000, 6800),
             ("adam", 6800, 6900, 7050), ("fwd", 7200, 7300, 7900),
             ("bwd", 7900, 8000, 8800)]


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", (0.4 + 0.6) / 2),
    ("backward_ms.train", (0.8 + 0.8) / 2),
])
def test_train_readers_on_a_hand_built_run(monkeypatch, name, want):
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(TRAIN_SPANS))
    assert _read(name, _run("gpt2-xl.train", TRAIN_OPS)) == pytest.approx(
        want)


NEW = ("decode_launch_ms.complete", "decode_prepare_ms.complete",
       "decode_stall_share.complete", "decode_device_ms.complete",
       "decode_launches.complete", "prefill_device_ms.complete",
       "launch_bound_idle.complete", "forward_ms.train", "backward_ms.train")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(monkeypatch, name):
    cell = "gpt2-xl.train" if name.endswith(".train") else \
        "starcoder2-3b.complete"
    spans = TRAIN_SPANS if cell == "gpt2-xl.train" else SERVE_SPANS
    run = _run(cell, SERVE_OPS + TRAIN_OPS)
    # a ring that wrapped past the start of the window and of the trace
    kept = [s for s in spans if s[1] > 6500]
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(
        kept, written=len(spans), capacity=len(kept)))
    assert _read(name, run) is None
    # no spans, and spans of other names
    monkeypatch.setattr(telemetry, "SPANS", FakeLog([]))
    assert _read(name, run) is None
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(
        [("other" + n[n.index("."):], a, b, c) for n, a, b, c in spans]))
    assert _read(name, run) is None
    # a program without a span log
    monkeypatch.delattr(telemetry, "SPANS")
    assert _read(name, run) is None


def test_a_wrapped_ring_still_reads_a_later_part(monkeypatch):
    """The ring lost spans after the window's start, none after the
    trace's."""
    kept = [s for s in SERVE_SPANS if s[1] >= 2300]
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(
        kept, written=len(SERVE_SPANS), capacity=len(kept)))
    run = _run("starcoder2-3b.complete", SERVE_OPS)
    assert _read("decode_launches.complete", run) == 3.0
    assert _read("decode_launch_ms.complete", run) is None


def test_the_programs_own_log_through_the_reader(monkeypatch):
    log = telemetry.SpanLog(capacity=64)
    monkeypatch.setattr(telemetry, "SPANS", log)
    t0 = time.time_ns()
    for rows in (2, 3):
        step = log.open("serving.step")
        sp = log.open("serving.step.forward")
        time.sleep(0.001)
        log.close(sp)
        log.close(step, (("live_rows", rows),))
    log.open("serving.step")                  # never closed: left out
    spans = program_spans.between(t0, time.time_ns())
    assert [s.name for s in spans] == ["serving.step",
                                       "serving.step.forward"] * 2
    assert [s.info for s in spans[::2]] == [{"live_rows": 2},
                                            {"live_rows": 3}]
    run = _run("starcoder2-3b.complete", [], traced=False)
    run.window = (t0, time.time_ns())
    assert _read("decode_launch_ms.complete", run) >= 1.0


def test_phase_breakdown_on_a_hand_built_run(serve):
    """``phase_breakdown`` (PERF.md's split of a cell's time) on the
    hand-built serving run."""
    from benchmark.tests import phase_breakdown

    # the benchmark's own spans around the two untraced steps
    serve.spans = [Span("step", T + 1200 * US, T + 2200 * US),
                   Span("step", T + 2300 * US, T + 2900 * US)]
    got = phase_breakdown.breakdown(serve, phase_breakdown.PAIRS["serve"])
    step = got["serving.step"]
    assert (step["n"], step["bench_n"]) == (2, 2)
    assert step["mean_ms"] == step["bench_mean_ms"] == pytest.approx(0.8)
    assert step["children_cover"] == pytest.approx(1.0)
    assert step["host_ms"] == pytest.approx({
        "serving.step.prepare": 0.075, "serving.step.forward": 0.575,
        "serving.step.sync": 0.115, "serving.step.bookkeep": 0.035})
    assert step["device_ms"] == pytest.approx(0.41)
    assert step["launches"] == {"serving.step.prepare": None,
                                "serving.step.forward": 2.0,
                                "serving.step.sync": 1.0,
                                "serving.step.bookkeep": None}
    assert step["phase_device_ms"]["serving.step.forward"] == \
        pytest.approx(0.4)
    # idle under each phase, of the 5000 µs trace: 100 + 300 µs under the
    # forward, 50 + 40 under the bookkeeping
    assert step["idle_pct"]["serving.step.forward"] == pytest.approx(8.0)
    assert step["idle_pct"]["serving.step.bookkeep"] == pytest.approx(1.8)
    admit = got["serving.admit"]
    assert admit["n"] == 1 and admit["children_cover"] is None
    assert admit["host_ms"]["serving.admit.forward"] == pytest.approx(0.75)
    assert admit["device_ms"] == pytest.approx(1.0)
    assert got["device_idle_pct"] == pytest.approx(69.8)
    # idle outside both outer spans: 5000-6000, 7000-7500, 9000-9600 and
    # 9700-10000 µs
    assert got["idle_outside_program_pct"] == pytest.approx(
        100 * (1000 + 500 + 600 + 300) / 5000)
    gaps = got["idle_gaps_ms"]
    assert gaps[0] == ["serving.step.prepare", pytest.approx(1.2)]
    assert ["harness", pytest.approx(0.3)] in gaps
    assert len(gaps) == 6


def test_span_cost_measures_each_form():
    from benchmark.tests import phase_breakdown

    got = phase_breakdown.span_cost(spans=2000, rounds=3)
    assert set(got) == {"span_ns", "span_with_counter_ns", "empty_loop_ns"}
    assert got["span_ns"] > 0 and got["span_with_counter_ns"] > 0


# -- on the card --------------------------------------------------------


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch


@pytest.mark.cuda
def test_program_spans_and_launches_share_a_clock(card):
    """A program span around one known launch holds that launch's CUPTI
    host time, and the kernel starts after the span opened."""
    from benchmark.harness.trace import DeviceTracer

    torch = card
    x = torch.ones(1 << 20, device="cuda")
    tracer = DeviceTracer(torch)
    tracer.warm()
    tracer.start()
    sp = telemetry.SPANS.open("clock.check")
    y = x * 3
    t1 = telemetry.SPANS.close(sp)
    t0 = telemetry.SPANS.t0_ns(sp)
    torch.cuda.synchronize()
    trace = tracer.stop()
    ops = trace.launched_within([Span("clock.check", t0, t1)])
    assert len(ops) == 1, trace.ops
    name, start, end, corr = ops[0]
    assert t0 <= trace.launch_ns[corr] <= t1
    assert t0 <= start <= end <= trace.t1
    assert float(y[0]) == 3.0


@pytest.mark.cuda
def test_program_steps_take_the_benchmarks_ops(card):
    """A short traced run of the serving cell at its own size: the device
    operations launched inside the program's ``serving.step`` spans are
    those launched inside the benchmark's ``step`` spans, with one
    ``paged_split_kernel`` a layer a step; the children of each program
    span cover its benchmark span to within 5%."""
    from benchmark.drivers import serve
    from benchmark.drivers.common import Context

    cell = "starcoder2-3b.complete"
    ctx = Context(torch=card, device="cuda", cell_name=cell,
                  cell=spec.load_cell(cell),
                  config=spec.load_config(spec.cell_entry(
                      spec.load_benchmark(), cell)["config"]),
                  seed=2**33 + 5, seconds=12.0, traced=True,
                  process_start=time.time())
    run, outcome = serve.run(ctx)
    assert outcome.correct, outcome.checks
    trace = run.trace
    mine = program_spans.named(program_spans.traced_part(run),
                               "serving.step")
    theirs = [s for s in run.spans_named("step")
              if trace.t0 <= s.t0 and s.t1 <= trace.t1]
    assert mine and len(mine) == len(theirs)
    ops = trace.launched_within(mine)
    assert {o[3] for o in ops} == {
        o[3] for o in trace.launched_within(theirs)}
    paged = [o for o in ops if "paged_split_kernel" in o[0]]
    assert len(paged) == 30 * len(mine) == run.sizes["layers"] * len(mine)

    host = program_spans.host_part(run)
    for ours, bench in (("serving.step", "step"), ("serving.admit",
                                                   "admit")):
        parents = program_spans.named(host, ours)
        kids = program_spans.inside(parents, [
            s for s in host if s.name.startswith(ours + ".")])
        spans = [s for s in run.spans_named(bench)
                 if s.t1 <= run.untraced_end]
        outer = program_spans.inside(spans, parents)
        assert sorted(len(v) for v in outer.values()) == [1] * len(spans)
        covered = sum(s.t1 - s.t0 for v in kids.values() for s in v)
        total = sum(s.t1 - s.t0 for s in spans)
        assert covered >= 0.95 * total, (ours, covered / total)
