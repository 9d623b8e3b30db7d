"""The device's activity in a traced window, from ``torch.profiler``
(CUPTI): every kernel, copy and fill the card ran, with its name and its
start and end on the profiler's clock, which is the host's wall clock
(``record.now_ns``); and each launch's host time, by correlation id.

Device activity only: a trace of every host operator over a whole window
takes the profiler minutes to fold."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

from .record import Span, now_ns


class DeviceTrace:
    """Device activity inside the window [t0, t1] (ns). ``ops`` holds
    (name, start, end, correlation) sorted by start; ``launch_ns`` maps a
    correlation id to the host time of the runtime call that launched
    it, where the profiler recorded one."""

    def __init__(self, t0: int, t1: int, ops, launch_ns: Dict[int, int]):
        self.t0, self.t1 = t0, t1
        self.ops = sorted(ops, key=lambda o: o[1])
        self.launch_ns = launch_ns

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _merged(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, a, b, _ in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, at = [], self.t0
        for a, b in self._merged():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def named(self, part: str) -> List[Tuple[str, int, int, int]]:
        """Operations whose name holds ``part``, in device order."""
        return [o for o in self.ops if part in o[0]]

    def launched_within(self, spans: Sequence[Span]):
        """Operations launched by the host inside any of ``spans``, or
        None where the profiler recorded no launch times."""
        if not self.launch_ns:
            return None
        bounds = sorted((s.t0, s.t1) for s in spans)
        starts = [a for a, _ in bounds]
        out = []
        for op in self.ops:
            at = self.launch_ns.get(op[3])
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= bounds[i][1]:
                out.append(op)
        return out

    def top_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, a, b, _ in self.ops:
            total[name] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[_short(n), t / 1e9] for n, t in top]

    def labelled_gaps(self, spans: Sequence[Span], k: int = 10):
        """The ``k`` longest idle gaps, each named by the host span that
        covers most of it ("harness" where none does)."""
        out = []
        for a, b in sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:k]:
            best, label = 0, "harness"
            for s in spans:
                cover = min(b, s.t1) - max(a, s.t0)
                if cover > best:
                    best, label = cover, s.name
            out.append([label, (b - a) / 1e9])
        return out


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit]


def _events(prof) -> Iterable:
    return prof.profiler.kineto_results.events()


def _corr(event) -> int:
    get = getattr(event, "correlation_id", None)
    return int(get()) if get is not None else -1


class DeviceTracer:
    """``torch.profiler`` with device activity only, started and stopped
    by the driver between its calls into the program (when the card has
    drained). ``warm`` runs one short session in set-up, so that the
    profiler's own start-up cost falls outside the window."""

    def __init__(self, torch):
        self.torch = torch
        self._prof = None
        self._t0 = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def warm(self) -> None:
        with self._profile():
            x = self.torch.ones(1024, device="cuda")
            (x * 2).sum().item()

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = now_ns()

    def stop(self) -> DeviceTrace:
        from torch.autograd import DeviceType

        self.torch.cuda.synchronize()
        t1 = now_ns()
        self._prof.__exit__(None, None, None)
        ops, launch_ns = [], {}
        for e in _events(self._prof):
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if "aunch" in name or "emcpy" in name or "emset" in name:
                    launch_ns[_corr(e)] = e.start_ns()
                continue
            ops.append((e.name(), e.start_ns(), e.end_ns(), _corr(e)))
        launch_ns.pop(-1, None)
        self._prof = None
        return DeviceTrace(self._t0, t1, ops, launch_ns)
