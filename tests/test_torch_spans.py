"""The port's phase-span log (``workloads/telemetry.py`` ``SpanLog``) and
the spans the serving engine and the train step write into it: the ring's
bound and wrap, the wall clock, and on a tiny CPU engine and train step
the exact span sequence of each call, each child inside its parent in
order, with the parent's counter. The engine's flight-recorder records
take their times from the same spans, the step records from the same
clock."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elastic_tpu_agent_torch.workloads import serving as ts  # noqa: E402
from elastic_tpu_agent_torch.workloads import telemetry as ttel  # noqa: E402
from elastic_tpu_agent_torch.workloads import transformer as tt  # noqa: E402

CFG = tt.ModelConfig(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                     max_seq=96, dtype=torch.float32)
ENGINE = dict(slots=3, max_len=64, prompt_buckets=(8, 16), block_size=4,
              device="cpu")
STEP = ["serving.step", "serving.step.prepare", "serving.step.forward",
        "serving.step.sync", "serving.step.bookkeep"]
ADMIT = ["serving.admit", "serving.admit.claim", "serving.admit.forward",
         "serving.admit.sample", "serving.admit.finish"]


@pytest.fixture
def log(monkeypatch):
    """A fresh span log in place of the process's, for every writer."""
    fresh = ttel.SpanLog(capacity=1024)
    for mod in (ttel, ts, tt):
        monkeypatch.setattr(mod, "SPANS", fresh)
    return fresh


def _since(log, start):
    """The closed spans opened at index ``start`` or later."""
    written, spans = log.read()
    assert written <= log.capacity
    return spans[start:]


def _check_nesting(spans):
    """The first span is the parent; the rest lie inside it, in order,
    without overlap."""
    (_, p0, p1, _), kids = spans[0], spans[1:]
    at = p0
    for _, a, b, _ in kids:
        assert at <= a <= b <= p1
        at = b


def _calls(log, fn):
    start = log.written
    out = fn()
    return out, _since(log, start)


@pytest.fixture(scope="module")
def params():
    return tt.init_params(CFG, torch.Generator().manual_seed(0), "cpu")


def test_ring_is_bounded_and_reports_a_wrap():
    log = ttel.SpanLog(capacity=8)
    first = log.open("s0")
    for i in range(1, 20):
        log.close(log.open(f"s{i}"), (("i", i),))
    log.close(first, (("i", 0),))      # overwritten long ago: a no-op
    written, spans = log.read()
    assert written == 20 and len(spans) == 8
    assert [s[0] for s in spans] == [f"s{i}" for i in range(12, 20)]
    assert [dict(s[3]) for s in spans] == [{"i": i} for i in range(12, 20)]
    assert all(a <= b for _, a, b, _ in spans)
    with pytest.raises(ValueError):
        ttel.SpanLog(capacity=12)


def test_span_times_are_wall_clock_readings(log):
    before = time.time_ns()
    sp = log.open("x")
    time.sleep(0.002)
    t1 = log.close(sp)
    after = time.time_ns()
    t0 = log.t0_ns(sp)
    assert before <= t0 < t1 <= after
    assert t1 - t0 >= 2_000_000
    # not the monotonic clock, which counts from the machine's boot
    assert abs(t0 - time.monotonic_ns()) > 10**15
    assert log.read()[1] == [("x", t0, t1, ())]
    # a span left open (an exception, a refused admission) is not read
    log.open("never.closed")
    assert log.written == 2 and log.read()[1] == [("x", t0, t1, ())]


def test_admit_and_step_write_their_phase_spans(log, params):
    rec = ttel.FlightRecorder(path="", trace_id="")
    eng = ts.ServingEngine(params, CFG, **ENGINE, recorder=rec)
    prompt = [5, 17, 42, 9, 1, 2, 3, 4, 6]
    rid, spans = _calls(log, lambda: eng.admit(prompt))
    assert [s[0] for s in spans] == ADMIT
    _check_nesting(spans)
    assert dict(spans[0][3]) == {"live_rows": 0}
    # on the CPU the prefill's attention is the einsum, never the kernel
    assert [dict(s[3]) for s in spans[1:]] == [
        {}, {"self_attn_kernel": 0}, {}, {}]
    used = eng.used_blocks
    out, spans = _calls(log, eng.step)
    assert list(out) == [rid]
    assert [s[0] for s in spans] == STEP
    _check_nesting(spans)
    assert dict(spans[0][3]) == {"live_rows": 1}
    assert eng.used_blocks >= used
    # the records' times are the outer spans'
    admit, step = rec.records
    for r, s in ((admit, log.read()[1][0]), (step, spans[0])):
        assert r["duration_ms"] == round((s[2] - s[1]) / 1e6, 3)
    # a second admission counts the live row before it
    _, spans = _calls(log, lambda: eng.admit([3, 88]))
    assert dict(spans[0][3]) == {"live_rows": 1}
    # a refused admission leaves no span to be read
    start = log.written
    with pytest.raises(ValueError):
        eng.admit([])
    assert log.written == start + 2 and _since(log, start) == []


def test_cache_hit_admission_and_chunked_step(log, params):
    eng = ts.ServingEngine(params, CFG, **ENGINE, prefix_cache=True)
    eng.admit([5, 17, 42, 9, 1, 2, 3, 4, 6])
    # shares the first two blocks: the tail prefills chunked
    _, spans = _calls(log, lambda: eng.admit([5, 17, 42, 9, 1, 2, 3, 4, 7,
                                              8]))
    assert [s[0] for s in spans] == ADMIT
    _check_nesting(spans)
    assert dict(spans[0][3]) == {"live_rows": 1}
    # the tail's chunks start past the shared blocks: no kernel
    assert dict(spans[2][3]) == {"self_attn_kernel": 0}
    assert eng.adoptions_total == 1
    rid = eng.enqueue([61, 3, 88, 24, 7, 7, 13, 2, 90, 41, 5])
    _, spans = _calls(log, eng.step)
    assert [s[0] for s in spans] == [STEP[0], "serving.step.prefill_chunk",
                                     *STEP[1:]]
    _check_nesting(spans)
    assert dict(spans[0][3]) == {"live_rows": 2}
    # a step with only the pending prefill and no live row
    eng2 = ts.ServingEngine(params, CFG, **ENGINE)
    eng2.enqueue(np.arange(1, 12))
    _, spans = _calls(log, eng2.step)
    assert [s[0] for s in spans] == [STEP[0], "serving.step.prefill_chunk"]
    assert rid in eng._pending


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_writes_forward_backward_optimizer(log, accum):
    """``loss_and_grads`` writes the forward and backward spans of each
    micro-batch inside the step's."""
    step, init_all, _ = tt.make_train_step(CFG, accum_steps=accum,
                                           device="cpu")
    p, state = init_all(torch.Generator().manual_seed(1))
    shape = (2, 9) if accum == 1 else (accum, 2, 9)
    tokens = torch.randint(0, CFG.vocab, shape,
                           generator=torch.Generator().manual_seed(2))
    _, spans = _calls(log, lambda: step(p, state, tokens))
    # under accumulation a train.reduce span adds each micro-batch's
    # gradients to the sum, and one more takes their mean
    micro = ["train.forward", "train.backward"] + (
        ["train.reduce"] if accum > 1 else [])
    assert [s[0] for s in spans] == (
        ["train.step"] + micro * accum + ["train.reduce"] * (accum > 1)
        + ["train.optimizer"])
    _check_nesting(spans)
    assert spans[0][3] == ()


def test_step_timer_records_its_span(log):
    """The runner's step record carries its start and length on the span
    log's clock; the train step's own spans are in the log, so the
    record writes none."""
    rec = ttel.FlightRecorder(path="", trace_id="", device="cpu")
    before = time.time_ns()
    with rec.step(3, tokens=64):
        time.sleep(0.001)
    after = time.time_ns()
    assert log.written == 0
    r = rec.records[-1]
    assert before <= r["t0_ns"] <= after
    assert 1.0 <= r["duration_ms"] <= (after - r["t0_ns"]) / 1e6
    assert r["tokens_per_s"] == pytest.approx(
        64 / (r["duration_ms"] / 1e3), rel=1e-3)


@pytest.mark.cuda
def test_bare_prompt_admission_counts_the_kernel_on_a_card(log):
    """On a card a bf16 prompt admitted from position 0 takes the flash
    kernel (``self_attn_kernel`` 1, one launch a layer); a prefix-hit
    admission's tail chunks do not (0, no launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from elastic_tpu_agent_torch.workloads import attention as ta

    cfg = tt.ModelConfig(vocab=97, d_model=256, n_heads=2, n_kv_heads=1,
                         n_layers=2, d_ff=64, max_seq=96, pos="rope")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    eng = ts.ServingEngine(params, cfg, slots=3, max_len=64,
                           prompt_buckets=(16, 32), block_size=4,
                           prefix_cache=True, device="cuda")
    prompt = [5, 17, 42, 9, 1, 2, 3, 4, 6]
    for want, p in ((1, prompt), (0, prompt + [7, 8])):
        before = ta.FLASH_FWD.launches
        _, spans = _calls(log, lambda: eng.admit(p))
        assert [s[0] for s in spans] == ADMIT
        assert dict(spans[2][3]) == {"self_attn_kernel": want}
        assert ta.FLASH_FWD.launches - before == want * cfg.n_layers
