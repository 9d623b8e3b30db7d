"""launch_bound_idle.complete: the share of the traced window in which
the device runs nothing while the host is inside ``serving.step.forward``
or ``serving.admit.forward``: idle that comes from issuing kernels more
slowly than the card runs them, in % (a part of device_idle)."""

from benchmark.harness.program_spans import idle_inside


def read(run):
    return idle_inside(run, "serving.step.forward", "serving.admit.forward")
