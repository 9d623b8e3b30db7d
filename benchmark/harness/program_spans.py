"""The program's own phase spans, for the readers of per-layer metrics.

The port keeps a span log (``workloads.telemetry.SPANS``): its serving
engine writes ``serving.admit`` and ``serving.step`` with a span for each
phase inside them, its train step ``train.step`` with ``train.forward``,
``train.backward`` and ``train.optimizer``, all on the wall clock that the
profiler stamps device activity on (``record.now_ns``). Here they become
``record.Span``s, each with its counters as ``info``.

A program that keeps no span log, or whose ring no longer reaches back to
the start of the part read, gives nothing, and the readers return None.
Host-clock readings come from the part of the window before the profiler
started (``Run.untraced_end``), device readings from the traced part."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

from .record import Span


def _log():
    try:
        from elastic_tpu_agent_torch.workloads.telemetry import SPANS
    except ImportError:          # a program without the span log
        return None
    return SPANS


def between(t0: int, t1: int) -> Optional[List[Span]]:
    """The program's spans that lie inside [t0, t1] (ns), oldest first;
    None where there are none or the ring has lost spans after t0."""
    log = _log()
    if log is None:
        return None
    written, entries = log.read()
    if written > log.capacity and (not entries or entries[0][1] > t0):
        return None
    out = [Span(name, a, b, dict(c)) for name, a, b, c in entries
           if t0 <= a and b <= t1]
    return out or None


def host_part(run) -> Optional[List[Span]]:
    return between(run.window[0], run.untraced_end)


def traced_part(run) -> Optional[List[Span]]:
    if run.trace is None:
        return None
    return between(run.trace.t0, run.trace.t1)


def named(spans: Sequence[Span], *names: str) -> List[Span]:
    return [s for s in spans if s.name in names]


def inside(parents: Sequence[Span], spans: Sequence[Span]) -> Dict[int, list]:
    """Each span of ``spans`` that lies inside one of ``parents`` (which do
    not overlap), grouped by the parent's index."""
    order = sorted(range(len(parents)), key=lambda i: parents[i].t0)
    starts = [parents[i].t0 for i in order]
    out: Dict[int, list] = {i: [] for i in range(len(parents))}
    for s in spans:
        k = bisect.bisect_right(starts, s.t0) - 1
        if k >= 0 and s.t1 <= parents[order[k]].t1:
            out[order[k]].append(s)
    return out


def host_ms_per(run, parent: str, *phases: str) -> Optional[float]:
    """Mean host ms a ``parent`` span spends inside its ``phases``."""
    spans = host_part(run)
    parents = named(spans or [], parent)
    if not parents:
        return None
    groups = inside(parents, named(spans, *phases))
    total = sum(s.t1 - s.t0 for g in groups.values() for s in g)
    return total / 1e6 / len(parents)


def launched(run, per: str, *names: str):
    """(device operations launched inside the traced window's spans named
    ``names``, or ``per`` where none are given; the count of ``per``
    spans), or None where either is missing."""
    spans = traced_part(run)
    parents = named(spans or [], per)
    if not parents:
        return None
    ops = run.trace.launched_within(named(spans, *names) if names
                                    else parents)
    return (ops, len(parents)) if ops else None


def device_ms_per(run, per: str, *names: str) -> Optional[float]:
    """Device ms a ``per`` span of the operations launched inside it (or
    inside its spans named ``names``)."""
    got = launched(run, per, *names)
    if got is None:
        return None
    ops, n = got
    return sum(b - a for _, a, b, _ in ops) / 1e6 / n


def stall_share(run) -> Optional[float]:
    """Of the live rows' time (each span's length times the rows live
    when it began), the share spent in ``serving.admit`` (a synchronous
    prefill, during which no live row advances), in %."""
    spans = host_part(run)
    if not spans:
        return None

    def row_ns(name):
        return sum((s.t1 - s.t0) * s.info.get("live_rows", 0)
                   for s in named(spans, name))

    stalled, advancing = row_ns("serving.admit"), row_ns("serving.step")
    if stalled + advancing <= 0:
        return None
    return 100.0 * stalled / (stalled + advancing)


def idle_inside(run, *names: str) -> Optional[float]:
    """Share of the traced window in which the device runs nothing while
    the host is inside a span named ``names``, in %."""
    spans = named(traced_part(run) or [], *names)
    if not spans:
        return None
    spans.sort(key=lambda s: s.t0)     # they do not overlap
    idle, i = 0, 0
    for a, b in run.trace.idle_gaps():
        while i < len(spans) and spans[i].t1 <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j].t0 < b:
            idle += min(b, spans[j].t1) - max(a, spans[j].t0)
            j += 1
    return 100.0 * idle / (run.trace.t1 - run.trace.t0)
