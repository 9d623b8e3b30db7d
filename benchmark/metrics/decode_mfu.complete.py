"""decode_mfu.complete: model FLOPs of the decode steps (2N a live row
plus its attention over its length) over the step() calls' host time at
the H100's bf16 peak, in %: the whole decode step's share of the chip's
peak, beside the paged kernel's roofline."""

from benchmark.harness.readers import decode_mfu


def read(run):
    return decode_mfu(run)
