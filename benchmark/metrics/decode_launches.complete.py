"""decode_launches.complete: device operations (kernels, copies, fills)
launched inside the program's ``serving.step`` spans, per step (traced
part of the window)."""

from benchmark.harness.program_spans import launched


def read(run):
    got = launched(run, "serving.step")
    return None if got is None else len(got[0]) / got[1]
