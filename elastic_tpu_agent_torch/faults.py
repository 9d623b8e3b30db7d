"""Deterministic fault injection: named failpoints, armed only in tests.

The port's copy of ``elastic_tpu_agent/faults.py`` (registry, spec syntax,
``DieThread``), its registry separate from the agent's. The port's bind
path fires the agent's points under the agent's names
(``bind.pre_journal``, ``bind.post_journal``, ``bind.post_create``,
``bind.post_spec``, ``bind.post_checkpoint``), as do its health poll
(``health.poll``), GC (``gc.sweep``), storage (``storage.*``), sitter
(``sitter.relist``, ``sitter.watch``), pod-resources client
(``podresources.list``) and reconciler (``reconciler.tick``).

The agent is a node-critical DaemonSet with ~8 background loops; proving
that each one recovers from a crash needs a way to *cause* the crash
deterministically — monkeypatching from tests cannot reach a loop that
is already running inside the real manager. This registry is that seam:
hot paths call ``faults.fire("<point>")`` which is a near-free no-op
until a test (or a developer via ``ELASTIC_TPU_FAULTS`` /
``--faults``) arms the point with a behavior spec.

Specs (``<kind>[:<arg>]``):

- ``raise`` / ``raise:N`` / ``raise-once`` — raise FaultError at the
  point, every time / the next N times / once. Exercises the *handled*
  error paths (loops that catch-and-retry, rollback on bind failure).
- ``delay:SECONDS`` — sleep at the point (slow apiserver / slow disk).
- ``die-thread`` / ``die-thread:N`` — raise DieThread, a BaseException
  that sails past every ``except Exception`` trap, killing the calling
  thread the way an uncaught bug would. This is what proves the
  supervisor actually restarts a loop: ``raise`` alone is absorbed by
  the loops' own catch-and-continue guards.
- ``notice`` / ``notice:N`` — a consumable signal rather than a fault:
  ``fire()`` ignores it; a poll site asks ``faults.check(point)``
  which returns True (and consumes one charge) while armed. This is
  how chaos tests inject external notifications the code merely polls
  for — e.g. ``drain.preempt-notice=notice:1`` makes the drain
  orchestrator see exactly one spot-preemption notice.

Brownout kinds (chaos-matrix material, sim/chaos.py): deterministic
one-shots cannot express a *flaky* dependency — a disk that fails one
write in three, an RPC that is slow by a different amount every call, a
dependency that is only broken for a while. These kinds are seeded, so
a chaos program replayed from the same seed trips the same calls:

- ``prob:P:SEED`` — raise FaultError with probability ``P`` per fire,
  decided by a private ``random.Random(SEED)`` stream (``prob:0.3:7``).
  Fires that do not trip consume nothing; ``fired`` counts trips only.
- ``delay-range:LO:HI:SEED`` — sleep a uniform duration in ``[LO, HI]``
  seconds per fire, drawn from the seeded stream
  (``delay-range:0.001:0.05:7``) — jittery-slow, not fixed-slow.
- ``window:START:DUR`` — raise FaultError only while the registry
  clock's monotonic time is within ``[armed_at+START, armed_at+START+
  DUR)`` — a brownout that begins and ends on schedule. Outside the
  window the point is a no-op (and never expires); chaos programs
  disarm it explicitly. The registry's ``clock`` attribute is the
  injectable time source (tests hand in a ManualClock).

Arming is test-only: production deployments never set the env knob, and
an unarmed ``fire()`` is a dict-emptiness check. Points are plain
dotted names (``sitter.relist``, ``storage.save``, ``gc.sweep``, ...);
firing an unknown point is always safe.

Full spec grammar::

    spec      := "raise" | "raise-once" | "raise:" N
               | "delay:" SECONDS
               | "die-thread" [":" N]
               | "notice" [":" N]
               | "prob:" P [":" SEED]
               | "delay-range:" LO ":" HI [":" SEED]
               | "window:" START ":" DUR
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, Optional

from .common import SYSTEM_CLOCK

logger = logging.getLogger(__name__)


class FaultError(RuntimeError):
    """The exception a ``raise``-kind failpoint throws (an ordinary
    Exception: the code under test is expected to handle it)."""


class DieThread(BaseException):
    """Thrown by ``die-thread`` failpoints. Deliberately a BaseException:
    it must escape the broad ``except Exception`` traps that the agent's
    loops use for *handled* failures, so the thread actually dies and
    the supervision layer is what has to save it."""


class _Fault:
    __slots__ = (
        "kind", "arg", "remaining", "fired",
        "rng", "lo", "hi", "win_start", "win_dur", "armed_at",
    )

    def __init__(self, kind: str, arg: Optional[float], remaining: Optional[int]):
        self.kind = kind
        self.arg = arg
        self.remaining = remaining  # None = unlimited
        self.fired = 0
        # seeded-kind state (prob / delay-range / window)
        self.rng: Optional[random.Random] = None
        self.lo = 0.0
        self.hi = 0.0
        self.win_start = 0.0
        self.win_dur = 0.0
        self.armed_at = 0.0  # registry clock at arm(); window anchor


def _parse_spec(spec: str) -> _Fault:
    spec = spec.strip()
    if spec == "raise-once":
        return _Fault("raise", None, 1)
    kind, _, arg = spec.partition(":")
    kind = kind.strip()
    if kind == "raise":
        n = int(arg) if arg else None
        return _Fault("raise", None, n)
    if kind == "delay":
        if not arg:
            raise ValueError("delay fault needs seconds: delay:0.5")
        return _Fault("delay", float(arg), None)
    if kind == "die-thread":
        n = int(arg) if arg else None
        return _Fault("die-thread", None, n)
    if kind == "notice":
        n = int(arg) if arg else None
        return _Fault("notice", None, n)
    if kind == "prob":
        parts = arg.split(":") if arg else []
        if not parts or not parts[0]:
            raise ValueError("prob fault needs a probability: prob:0.3:7")
        p = float(parts[0])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"prob fault probability out of [0,1]: {p}")
        fault = _Fault("prob", p, None)
        fault.rng = random.Random(int(parts[1]) if len(parts) > 1 else 0)
        return fault
    if kind == "delay-range":
        parts = arg.split(":") if arg else []
        if len(parts) < 2:
            raise ValueError(
                "delay-range fault needs bounds: delay-range:0.001:0.05:7"
            )
        fault = _Fault("delay-range", None, None)
        fault.lo, fault.hi = float(parts[0]), float(parts[1])
        if fault.hi < fault.lo:
            raise ValueError(
                f"delay-range bounds inverted: {fault.lo} > {fault.hi}"
            )
        fault.rng = random.Random(int(parts[2]) if len(parts) > 2 else 0)
        return fault
    if kind == "window":
        parts = arg.split(":") if arg else []
        if len(parts) != 2:
            raise ValueError("window fault needs start:dur: window:1.0:2.5")
        fault = _Fault("window", None, None)
        fault.win_start, fault.win_dur = float(parts[0]), float(parts[1])
        if fault.win_dur < 0:
            raise ValueError(f"window duration negative: {fault.win_dur}")
        return fault
    raise ValueError(
        f"unknown fault spec {spec!r} "
        "(want raise[-once|:N] | delay:S | die-thread[:N] | notice[:N] | "
        "prob:P[:SEED] | delay-range:LO:HI[:SEED] | window:START:DUR)"
    )


class FaultRegistry:
    """Thread-safe map of failpoint name -> armed behavior.

    ``clock`` is the injectable time source ``window`` kinds anchor to
    (monotonic); chaos tests hand in a ManualClock and advance it."""

    def __init__(self, clock=SYSTEM_CLOCK) -> None:
        self._lock = threading.Lock()
        self._armed: Dict[str, _Fault] = {}
        self.total_fired = 0
        self.clock = clock

    def arm(self, point: str, spec: str) -> None:
        fault = _parse_spec(spec)
        fault.armed_at = self.clock.monotonic()
        with self._lock:
            self._armed[point] = fault
        logger.warning("FAULT ARMED (test-only): %s=%s", point, spec)

    def arm_spec(self, multi: str) -> None:
        """Arm from a comma-separated ``point=spec,point=spec`` string
        (the ELASTIC_TPU_FAULTS / --faults format)."""
        for part in multi.split(","):
            part = part.strip()
            if not part:
                continue
            point, _, spec = part.partition("=")
            if not spec:
                raise ValueError(f"bad fault entry {part!r} (want point=spec)")
            self.arm(point.strip(), spec)

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def armed(self) -> Dict[str, str]:
        with self._lock:
            return {
                p: f"{f.kind}"
                + (f":{f.remaining}" if f.remaining is not None else "")
                for p, f in self._armed.items()
            }

    def fired(self, point: str) -> int:
        """How many times ``point`` fired while armed (assertion helper;
        resets when the point is re-armed)."""
        with self._lock:
            fault = self._armed.get(point)
            return fault.fired if fault is not None else 0

    def check(self, point: str) -> bool:
        """Consume one charge of a ``notice``-armed point: True while
        armed, False otherwise (and always False for non-notice kinds —
        ``fire()`` owns those). Poll sites use this to receive injected
        external signals deterministically."""
        with self._lock:
            fault = self._armed.get(point)
            if fault is None or fault.kind != "notice":
                return False
            fault.fired += 1
            self.total_fired += 1
            if fault.remaining is not None:
                fault.remaining -= 1
                if fault.remaining <= 0:
                    del self._armed[point]
        logger.warning("failpoint %s: notice consumed", point)
        return True

    def fire(self, point: str) -> None:
        with self._lock:
            fault = self._armed.get(point)
            if fault is None or fault.kind == "notice":
                return
            # Seeded/windowed kinds decide whether this call trips at
            # all BEFORE any charge is consumed: a prob fire that does
            # not trip (or a window fire outside the window) must leave
            # ``fired`` counting trips only — that is what chaos
            # verdicts assert against.
            if fault.kind == "prob":
                if fault.rng.random() >= fault.arg:
                    return
            elif fault.kind == "window":
                dt = self.clock.monotonic() - fault.armed_at
                if not (
                    fault.win_start <= dt < fault.win_start + fault.win_dur
                ):
                    return
            fault.fired += 1
            self.total_fired += 1
            if fault.remaining is not None:
                fault.remaining -= 1
                if fault.remaining <= 0:
                    del self._armed[point]
            kind, arg = fault.kind, fault.arg
            if kind == "delay-range":
                arg = fault.lo + fault.rng.random() * (fault.hi - fault.lo)
        # act outside the lock: delay must not serialize other points
        if kind in ("delay", "delay-range"):
            time.sleep(arg)
            return
        if kind == "die-thread":
            logger.warning("failpoint %s: killing thread %s", point,
                           threading.current_thread().name)
            raise DieThread(f"failpoint {point}")
        logger.warning("failpoint %s: raising FaultError", point)
        raise FaultError(f"injected failure at {point}")


_registry = FaultRegistry()


def get_registry() -> FaultRegistry:
    return _registry


def fire(point: str) -> None:
    """Module-level fast path: no-op unless the point is armed."""
    if not _registry._armed:  # unlocked emptiness check: hot-path cheap
        return
    _registry.fire(point)


def check(point: str) -> bool:
    """Module-level fast path for notice points (see
    :meth:`FaultRegistry.check`): False unless armed with ``notice``."""
    if not _registry._armed:
        return False
    return _registry.check(point)


class armed:
    """Context manager for tests: arm on enter, disarm on exit.

    >>> with faults.armed("gc.sweep", "die-thread:1"):
    ...     trigger_gc()
    """

    def __init__(self, point: str, spec: str) -> None:
        self._point = point
        _registry.arm(point, spec)

    def __enter__(self) -> "armed":
        return self

    def __exit__(self, *exc) -> None:
        _registry.disarm(self._point)
