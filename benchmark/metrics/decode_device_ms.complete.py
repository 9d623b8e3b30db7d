"""decode_device_ms.complete: device ms a decode step of the operations
(kernels, copies, fills) launched inside the program's ``serving.step``
spans, by CUPTI correlation ids (traced part of the window)."""

from benchmark.harness.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "serving.step")
