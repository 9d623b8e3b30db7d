"""``prefill_kernel_share.complete`` on hand-built span logs: the share of
the untraced part's admissions whose ``serving.admit.forward`` span
counts ``self_attn_kernel`` 1, and None where no span carries the
counter (a program that does not count it)."""

import pytest

from benchmark.tests.test_bench_spans import ADMIT, FakeLog, _phases, _read, \
    _run
from elastic_tpu_agent_torch.workloads import telemetry

NAME = "prefill_kernel_share.complete"


def _admissions(kernel, starts=(100, 1300, 2500, 3700, 6000)):
    """An admission at each start (µs), its forward span counting
    ``kernel[i]`` (None: no counter); the trace starts at 5000 µs."""
    spans = []
    for i, a in enumerate(starts):
        adm = _phases("serving.admit", a, a + 1000,
                      (a + 50, a + 800, a + 950), ADMIT, live_rows=1)
        if kernel[i] is not None:
            n, t0, t1, _ = adm[2]
            adm[2] = (n, t0, t1, {"self_attn_kernel": kernel[i]})
        spans += adm
    return spans


@pytest.mark.parametrize("kernel,want", [
    ((1, 1, 1, 1, 0), 100.0),    # the traced part's admission is left out
    ((1, 0, 1, 0, 1), 50.0),
    ((0, 0, 0, 0, 1), 0.0),
    ((1, None, 0, None, 1), 50.0),
])
def test_share_of_admissions_through_the_kernel(monkeypatch, kernel, want):
    monkeypatch.setattr(telemetry, "SPANS", FakeLog(_admissions(kernel)))
    run = _run("starcoder2-3b.complete", [])
    assert _read(NAME, run) == pytest.approx(want)


def test_untraced_run_reads_the_whole_window(monkeypatch):
    monkeypatch.setattr(telemetry, "SPANS",
                        FakeLog(_admissions((1, 1, 0, 0, 0))))
    run = _run("starcoder2-3b.complete", [], traced=False)
    assert _read(NAME, run) == pytest.approx(40.0)


def test_spans_without_the_counter_give_none(monkeypatch):
    run = _run("starcoder2-3b.complete", [])
    monkeypatch.setattr(telemetry, "SPANS",
                        FakeLog(_admissions((None,) * 5)))
    assert _read(NAME, run) is None
    # the counter only in the traced part
    monkeypatch.setattr(telemetry, "SPANS",
                        FakeLog(_admissions((None,) * 4 + (1,))))
    assert _read(NAME, run) is None
    monkeypatch.setattr(telemetry, "SPANS", FakeLog([]))
    assert _read(NAME, run) is None
    monkeypatch.delattr(telemetry, "SPANS")
    assert _read(NAME, run) is None
