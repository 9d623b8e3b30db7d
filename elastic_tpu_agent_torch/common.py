"""Injectable time source for the port, as ``elastic_tpu_agent/common.py``
defines it (``Clock``, ``SYSTEM_CLOCK``, ``ManualClock``): production code
takes a ``clock`` defaulting to :data:`SYSTEM_CLOCK`; tests hand in a
:class:`ManualClock` and advance it, so "an hour passed" is one method
call instead of a wall-clock wait. The port keeps its own copy: it imports
nothing of the JAX package."""

from __future__ import annotations

import time


class Clock:
    """Wall-clock and monotonic seconds."""

    def time(self) -> float:
        """Wall-clock seconds (``time.time()``)."""
        return time.time()

    def monotonic(self) -> float:
        """Monotonic seconds (``time.monotonic()``)."""
        return time.monotonic()


SYSTEM_CLOCK = Clock()


class ManualClock(Clock):
    """A clock that only moves when told to (tests). Starts at a fixed,
    recognizably fake wall time, so that an un-injected SYSTEM_CLOCK in a
    code path under test shows up as a wildly different timestamp."""

    def __init__(self, start: float = 1_000_000_000.0) -> None:
        self._time = start
        self._monotonic = 0.0

    def time(self) -> float:
        return self._time

    def monotonic(self) -> float:
        return self._monotonic

    def advance(self, seconds: float) -> None:
        self._time += seconds
        self._monotonic += seconds
