"""Subsystem supervision: every background loop gets a named guardian.

The port's copy of ``elastic_tpu_agent/supervisor.py``. The port's agent
runs its sitter, its device-plugin serve loops (one a resource), GC, the
card-health poll, the reconciler, the CRD and Event sink workers, the
profiler and the deferred allocatable check as supervised subsystems,
each with an uncaught-exception trap (including BaseException, so that a
fault-injected ``DieThread`` is caught too):

- a crash restarts the subsystem after a jittered exponential backoff;
- a crash-loop circuit breaker: ``crash_loop_threshold`` crashes inside
  a sliding window mark the subsystem ``failed`` instead of thrashing;
- a criticality class says what a circuit-broken subsystem means:
  ``critical`` (the serve loops, GC, the sitter) flips ``/healthz`` to
  503 and fires the terminal event on which ``NodeManager.run(block=
  True)`` blocks, so that the pod's liveness probe restarts the agent;
  ``degraded`` (health, reconciler, sinks, profiler) keeps binding alive
  and shows in ``/healthz`` and the ``elastic_tpu_subsystem_*`` metrics.

With ``metrics`` the up gauge and the restart and crash-loop counters are
kept; with a ``timeline`` restarts and breaker trips are journaled.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from . import faults
from .common import JitteredBackoff

logger = logging.getLogger(__name__)

# criticality classes
CRITICAL = "critical"
DEGRADED = "degraded"

# subsystem states
STATE_PENDING = "pending"      # registered, supervisor not started yet
STATE_RUNNING = "running"
STATE_BACKOFF = "backoff"      # crashed; waiting to restart
STATE_FAILED = "failed"        # circuit breaker open: no more restarts
STATE_STOPPED = "stopped"      # clean exit (global stop / owner stop)
STATE_DONE = "done"            # one-shot task completed

DEFAULT_CRASH_LOOP_THRESHOLD = 5
DEFAULT_CRASH_LOOP_WINDOW_S = 300.0
DEFAULT_BACKOFF_MIN_S = 0.5
DEFAULT_BACKOFF_MAX_S = 30.0


class _Subsystem:
    def __init__(
        self,
        name: str,
        target: Callable[[threading.Event], None],
        criticality: str,
        one_shot: bool,
    ) -> None:
        self.name = name
        self.target = target
        self.criticality = criticality
        self.one_shot = one_shot
        self.state = STATE_PENDING
        self.restarts = 0          # crashes that led to a restart
        self.crash_loops = 0       # times the circuit breaker opened
        self.last_error: Optional[str] = None
        self.last_crash_monotonic: Optional[float] = None
        self.started_monotonic: Optional[float] = None
        self.crash_times: List[float] = []   # sliding window
        self.thread: Optional[threading.Thread] = None


class Supervisor:
    """Registry + restart engine for the agent's background loops.

    ``register()`` may be called before or after ``start()``; targets
    registered after start are spawned immediately (the manager starts
    the sitter before the plugins, with restore() in between).
    """

    def __init__(
        self,
        metrics=None,
        crash_loop_threshold: int = DEFAULT_CRASH_LOOP_THRESHOLD,
        crash_loop_window_s: float = DEFAULT_CRASH_LOOP_WINDOW_S,
        backoff_min_s: float = DEFAULT_BACKOFF_MIN_S,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
        timeline=None,
    ) -> None:
        self._metrics = metrics
        # Lifecycle timeline (timeline.py): restarts and breaker trips
        # journaled so a history can say "the reconciler died twice
        # right before this pod's repairs stopped".
        self._timeline = timeline
        self._crash_loop_threshold = max(1, crash_loop_threshold)
        self._crash_loop_window_s = crash_loop_window_s
        self._backoff_min_s = backoff_min_s
        self._backoff_max_s = backoff_max_s
        self._lock = threading.Lock()
        self._subsystems: "Dict[str, _Subsystem]" = {}
        self._stop: Optional[threading.Event] = None
        self._started = False
        # Set on global stop OR when a critical subsystem circuit-breaks.
        self.terminal = threading.Event()

    # -- registration ---------------------------------------------------------

    def register(
        self,
        name: str,
        target: Callable[[threading.Event], None],
        criticality: str = DEGRADED,
        one_shot: bool = False,
    ) -> None:
        """Register ``target(stop_event)`` as a supervised subsystem.

        ``target`` is expected to run until the stop event is set (or, for
        ``one_shot`` tasks, to run to completion once). A return before
        stop without ``one_shot`` is treated as a crash: silently
        evaporating loops are the failure this module exists to catch.
        """
        if criticality not in (CRITICAL, DEGRADED):
            raise ValueError(f"unknown criticality {criticality!r}")
        with self._lock:
            if name in self._subsystems:
                raise ValueError(f"subsystem {name!r} already registered")
            sub = _Subsystem(name, target, criticality, one_shot)
            self._subsystems[name] = sub
            started = self._started
        if started:
            self._spawn(sub)

    # -- lifecycle ------------------------------------------------------------

    def start(self, stop: threading.Event) -> None:
        """Activate supervision; spawns every registered subsystem and
        arranges for ``terminal`` to fire when ``stop`` does."""
        with self._lock:
            if self._started:
                return
            self._stop = stop
            self._started = True
            pending = list(self._subsystems.values())
        threading.Thread(
            target=self._watch_stop, daemon=True, name="supervisor-terminal"
        ).start()
        for sub in pending:
            self._spawn(sub)

    def _watch_stop(self) -> None:
        self._stop.wait()
        self.terminal.set()

    def wait_terminal(self, timeout: Optional[float] = None) -> bool:
        return self.terminal.wait(timeout)

    def join(self, name: str, timeout: Optional[float] = None) -> None:
        """Join one subsystem's supervision thread (shutdown ordering)."""
        with self._lock:
            sub = self._subsystems.get(name)
            thread = sub.thread if sub is not None else None
        if thread is not None:
            thread.join(timeout)

    def _spawn(self, sub: _Subsystem) -> None:
        t = threading.Thread(
            target=self._supervise, args=(sub,), daemon=True,
            name=f"supervised-{sub.name}",
        )
        sub.thread = t
        t.start()

    # -- the supervision loop -------------------------------------------------

    def _set_up_gauge(self, sub: _Subsystem, up: bool) -> None:
        m = self._metrics
        if m is not None and hasattr(m, "subsystem_up"):
            try:
                m.subsystem_up.labels(subsystem=sub.name).set(1.0 if up else 0.0)
            except Exception:  # noqa: BLE001 - metrics must not break supervision
                pass

    def _count(self, sub: _Subsystem, metric_name: str) -> None:
        m = self._metrics
        if m is not None and hasattr(m, metric_name):
            try:
                getattr(m, metric_name).labels(subsystem=sub.name).inc()
            except Exception:  # noqa: BLE001
                pass

    def _supervise(self, sub: _Subsystem) -> None:
        stop = self._stop
        backoff = JitteredBackoff(self._backoff_min_s, self._backoff_max_s)
        while not stop.is_set():
            sub.state = STATE_RUNNING
            sub.started_monotonic = time.monotonic()
            self._set_up_gauge(sub, True)
            error: Optional[BaseException] = None
            try:
                sub.target(stop)
            except faults.DieThread as e:
                error = e
            except BaseException as e:  # noqa: BLE001 - the whole point
                error = e
                logger.exception("subsystem %s crashed", sub.name)
            uptime = time.monotonic() - sub.started_monotonic
            if error is None:
                if stop.is_set() or sub.one_shot:
                    sub.state = (
                        STATE_DONE if sub.one_shot and not stop.is_set()
                        else STATE_STOPPED
                    )
                    self._set_up_gauge(sub, False)
                    return
                error = RuntimeError(
                    "subsystem returned before stop (silent loop death)"
                )
                logger.error("subsystem %s: %s", sub.name, error)
            # -- crash accounting ---------------------------------------------
            now = time.monotonic()
            sub.last_error = f"{type(error).__name__}: {error}"
            sub.last_crash_monotonic = now
            sub.crash_times.append(now)
            cutoff = now - self._crash_loop_window_s
            sub.crash_times = [t for t in sub.crash_times if t >= cutoff]
            self._set_up_gauge(sub, False)
            if len(sub.crash_times) >= self._crash_loop_threshold:
                # circuit breaker: stop thrashing; surface loudly instead
                sub.state = STATE_FAILED
                sub.crash_loops += 1
                self._count(sub, "subsystem_crash_loops")
                logger.error(
                    "subsystem %s FAILED: %d crashes within %.0fs "
                    "(last: %s) — circuit breaker open, no more restarts%s",
                    sub.name, len(sub.crash_times),
                    self._crash_loop_window_s, sub.last_error,
                    "; CRITICAL: flipping /healthz to 503 so the liveness "
                    "probe restarts this pod"
                    if sub.criticality == CRITICAL else "",
                )
                if self._timeline is not None:
                    from .timeline import KIND_SUBSYSTEM_CRASH_LOOP

                    self._timeline.emit(
                        KIND_SUBSYSTEM_CRASH_LOOP,
                        subsystem=sub.name,
                        criticality=sub.criticality,
                        crashes_in_window=len(sub.crash_times),
                        error=sub.last_error,
                    )
                if sub.criticality == CRITICAL:
                    self.terminal.set()
                return
            sub.restarts += 1
            self._count(sub, "subsystem_restarts")
            if self._timeline is not None:
                from .timeline import KIND_SUBSYSTEM_RESTART

                self._timeline.emit(
                    KIND_SUBSYSTEM_RESTART,
                    subsystem=sub.name, restart=sub.restarts,
                    error=sub.last_error,
                )
            if uptime > 2 * self._backoff_max_s:
                backoff.reset()  # it ran long enough: healthy again
            delay = backoff.next_delay()
            logger.warning(
                "subsystem %s: restart #%d in %.2fs (crash: %s)",
                sub.name, sub.restarts, delay, sub.last_error,
            )
            sub.state = STATE_BACKOFF
            if stop.wait(delay):
                break
        sub.state = STATE_STOPPED
        self._set_up_gauge(sub, False)

    # -- introspection --------------------------------------------------------

    def status(self) -> Dict[str, dict]:
        """Per-subsystem snapshot for /healthz and the doctor bundle."""
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self._lock:
            subs = list(self._subsystems.values())
        for sub in subs:
            out[sub.name] = {
                "criticality": sub.criticality,
                "state": sub.state,
                "restarts": sub.restarts,
                "crash_loops": sub.crash_loops,
                "last_error": sub.last_error,
                "uptime_s": (
                    round(now - sub.started_monotonic, 3)
                    if sub.state == STATE_RUNNING
                    and sub.started_monotonic is not None else None
                ),
            }
        return out

    def critical_failed(self) -> List[str]:
        with self._lock:
            return sorted(
                s.name for s in self._subsystems.values()
                if s.state == STATE_FAILED and s.criticality == CRITICAL
            )

    def degraded_subsystems(self) -> List[str]:
        """Non-critical subsystems that are circuit-broken (plus any
        subsystem currently crash-restarting): the node still binds, but
        an operator should know."""
        with self._lock:
            return sorted(
                s.name for s in self._subsystems.values()
                if (s.state == STATE_FAILED and s.criticality != CRITICAL)
                or s.state == STATE_BACKOFF
            )

    def healthz(self) -> dict:
        """The /healthz contract: ``critical_failed`` non-empty means the
        endpoint answers 503 (liveness probe restarts the pod)."""
        return {
            "critical_failed": self.critical_failed(),
            "degraded": self.degraded_subsystems(),
            "subsystems": self.status(),
        }


# -- process-wide thread-death accounting -------------------------------------
#
# Even with every known loop supervised, a thread someone forgot to
# register (or a library thread) can still die on an uncaught exception.
# threading.excepthook is the process-wide net: every such death bumps
# elastic_tpu_thread_crashes_total so it at least cannot happen
# *unobserved*.

_thread_crashes = 0
_thread_crashes_lock = threading.Lock()


def thread_crash_count() -> int:
    return _thread_crashes


def install_thread_excepthook(metrics=None):
    """Install a counting threading.excepthook; returns the previous hook
    (pass it to ``uninstall_thread_excepthook`` to restore — tests)."""
    previous = threading.excepthook

    def _hook(args):
        global _thread_crashes
        with _thread_crashes_lock:
            _thread_crashes += 1
        if metrics is not None and hasattr(metrics, "thread_crashes"):
            try:
                metrics.thread_crashes.inc()
            except Exception:  # noqa: BLE001
                pass
        name = args.thread.name if args.thread is not None else "?"
        logger.error(
            "unsupervised thread %r died: %s: %s",
            name, getattr(args.exc_type, "__name__", args.exc_type),
            args.exc_value,
        )
        try:
            previous(args)
        except Exception:  # noqa: BLE001 - never raise from the hook
            pass

    threading.excepthook = _hook
    return previous


def uninstall_thread_excepthook(previous) -> None:
    threading.excepthook = previous
