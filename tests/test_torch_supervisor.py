"""The port's supervisor (``supervisor.py``) against the agent's.

The same crash schedule, a subsystem that raises (or dies on a
``die-thread`` failpoint, or returns before stop) a set number of times,
goes through both supervisors. They must give the same restart counts,
the same circuit-breaker trip, and the same ``status()``,
``critical_failed()``, ``healthz()`` and ``wait_terminal`` results, for
critical and degraded subsystems and for one-shot tasks. Backoffs are a
few milliseconds; every wait is on a condition with a generous deadline.
"""

import threading
import time

import pytest

pytest.importorskip("torch")

from elastic_tpu_agent import faults as agent_faults  # noqa: E402
from elastic_tpu_agent import supervisor as agent_sup  # noqa: E402
from elastic_tpu_agent_torch import faults as port_faults  # noqa: E402
from elastic_tpu_agent_torch import supervisor as port_sup  # noqa: E402

SIDES = {"port": (port_sup, port_faults), "agent": (agent_sup, agent_faults)}
FAST = dict(backoff_min_s=0.001, backoff_max_s=0.002)


def make_target(faults, failures: int, how: str, one_shot: bool):
    """A target that fails ``failures`` times (``raise``: RuntimeError;
    ``die``: the ``sup.test`` failpoint armed ``die-thread``; ``return``:
    a return before stop), then runs until stop (or, one-shot, returns)."""
    calls = {"n": 0}

    def target(stop):
        calls["n"] += 1
        if calls["n"] <= failures:
            if how == "raise":
                raise RuntimeError(f"boom {calls['n']}")
            if how == "die":
                faults.fire("sup.test")
            return
        if not one_shot:
            stop.wait()

    return target, calls


# (criticality, failures, how, one_shot, threshold, settled state)
SCHEDULES = {
    "critical_recovers": ("critical", 2, "raise", False, 5, "running"),
    "critical_trips": ("critical", 9, "raise", False, 3, "failed"),
    "degraded_trips": ("degraded", 9, "raise", False, 3, "failed"),
    "degraded_recovers": ("degraded", 1, "raise", False, 3, "running"),
    "die_thread": ("critical", 2, "die", False, 5, "running"),
    "silent_return": ("degraded", 2, "return", False, 5, "running"),
    "one_shot": ("degraded", 0, "raise", True, 5, "done"),
    "one_shot_retried": ("critical", 1, "raise", True, 5, "done"),
}


def drive(side: str, name: str):
    sup_mod, faults = SIDES[side]
    crit, failures, how, one_shot, threshold, settled = SCHEDULES[name]
    sup = sup_mod.Supervisor(crash_loop_threshold=threshold, **FAST)
    target, calls = make_target(faults, failures, how, one_shot)
    stop = threading.Event()
    if how == "die":
        faults.get_registry().arm("sup.test", f"die-thread:{failures}")
    try:
        # one subsystem registered before start, one after (the manager
        # registers the sitter after start)
        sup.register("steady", lambda s: s.wait(), sup_mod.DEGRADED)
        sup.start(stop)
        sup.register("sub", target, crit, one_shot=one_shot)
        # Wait until both subsystems have settled before reading: the
        # schedule's subsystem in its final state, and the steady one
        # running. A fast schedule (one_shot_retried ends within a few
        # milliseconds) can otherwise be read while the steady thread has
        # not yet left "pending" on one side only.
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            st = sup.status()
            if (st["sub"]["state"] == settled
                    and (settled != "running" or calls["n"] > failures)
                    and st["steady"]["state"] == "running"):
                break
            time.sleep(0.005)
        out = dict(
            status=_strip(sup.status()),
            critical_failed=sup.critical_failed(),
            degraded=sup.degraded_subsystems(),
            healthz=_strip(sup.healthz()["subsystems"]),
            healthz_keys=sorted(sup.healthz()),
            terminal_before_stop=sup.wait_terminal(0.05),
            calls=calls["n"],
        )
        stop.set()
        out["terminal_after_stop"] = sup.wait_terminal(5.0)
        sup.join("sub", timeout=5.0)
        sup.join("steady", timeout=5.0)
        out["final"] = _strip(sup.status())
        return out
    finally:
        stop.set()
        faults.get_registry().disarm("sup.test")


def _strip(status):
    """status() without the uptime (a clock reading)."""
    return {k: {f: v for f, v in s.items() if f != "uptime_s"}
            for k, s in status.items()}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_crash_schedule_matches_the_agents(name):
    port, agent = drive("port", name), drive("agent", name)
    assert port == agent
    crit, failures, how, one_shot, threshold, settled = SCHEDULES[name]
    sub = port["status"]["sub"]
    assert sub["state"] == settled
    if settled == "failed":
        assert sub["restarts"] == threshold - 1
        assert sub["crash_loops"] == 1
        assert port["terminal_before_stop"] == (crit == "critical")
        assert port["critical_failed"] == (["sub"] if crit == "critical"
                                           else [])
    else:
        assert sub["restarts"] == failures
        assert not port["terminal_before_stop"]
    assert port["terminal_after_stop"]
    assert port["final"]["steady"]["state"] == "stopped"


def test_register_twice_and_unknown_criticality_raise():
    for sup_mod, _ in SIDES.values():
        sup = sup_mod.Supervisor()
        sup.register("x", lambda s: s.wait())
        with pytest.raises(ValueError):
            sup.register("x", lambda s: s.wait())
        with pytest.raises(ValueError):
            sup.register("y", lambda s: s.wait(), "fatal")


# the thread dies on purpose; the hook chains to pytest's, which warns
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_thread_excepthook_counts_unsupervised_deaths():
    before = port_sup.thread_crash_count()
    prev = port_sup.install_thread_excepthook()
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="doomed")
        t.start()
        t.join()
    finally:
        port_sup.uninstall_thread_excepthook(prev)
    assert port_sup.thread_crash_count() == before + 1
