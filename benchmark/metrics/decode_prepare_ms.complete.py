"""decode_prepare_ms.complete: mean host ms a decode step spends in the
program's ``serving.step.prepare`` (block tables and their copies to the
device) and ``serving.step.bookkeep`` (streams, finishes) spans
(untraced part of the window)."""

from benchmark.harness.program_spans import host_ms_per


def read(run):
    return host_ms_per(run, "serving.step", "serving.step.prepare",
                       "serving.step.bookkeep")
