"""What a run records for the metric readers: the benchmark's own host
spans around its calls into the program, each request or step, counters,
and, in a traced run, the device's activity."""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


def now_ns() -> int:
    """The host clock of every span: the wall clock, on which the
    profiler also stamps device activity."""
    return time.time_ns()


@dataclasses.dataclass
class Span:
    name: str
    t0: int
    t1: int
    info: Dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


@dataclasses.dataclass
class Run:
    """One run of one cell. ``window`` is (start, end) in ns of the
    measured window; ``requests`` (serving) and ``steps`` (training) are
    the driver's records; ``trace`` is a ``trace.DeviceTrace`` of the
    traced part of the window, or None."""

    cell_name: str
    cell: Dict
    config: Dict
    sizes: Dict
    seed: int
    seconds: float
    traced: bool
    setup_s: float = 0.0
    window: tuple = (0, 0)
    spans: List[Span] = dataclasses.field(default_factory=list)
    requests: List[Dict] = dataclasses.field(default_factory=list)
    steps: List[Dict] = dataclasses.field(default_factory=list)
    counters: Dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def untraced_end(self) -> int:
        """End (ns) of the part of the window the profiler did not run
        in: host-clock readings of a traced run stop there."""
        return self.trace.t0 if self.trace is not None else self.window[1]

    @contextmanager
    def span(self, name: str, **info):
        s = Span(name, now_ns(), 0, info)
        try:
            yield s
        finally:
            s.t1 = now_ns()
            self.spans.append(s)

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def untraced_spans(self, name: str) -> List[Span]:
        return [s for s in self.spans_named(name)
                if s.t1 <= self.untraced_end]
