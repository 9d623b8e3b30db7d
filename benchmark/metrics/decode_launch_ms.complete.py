"""decode_launch_ms.complete: mean host ms a decode step spends in the
program's ``serving.step.forward`` span, where the host issues the
step's kernels (untraced part of the window)."""

from benchmark.harness.program_spans import host_ms_per


def read(run):
    return host_ms_per(run, "serving.step", "serving.step.forward")
