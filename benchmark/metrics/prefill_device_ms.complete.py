"""prefill_device_ms.complete: device ms an admission of the operations
launched inside the program's ``serving.admit`` spans (the synchronous
prefill and the first token's sampling; traced part of the window)."""

from benchmark.harness.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "serving.admit")
