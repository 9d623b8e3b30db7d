"""prefill_mfu.complete: model FLOPs of the admitted prompts (unpadded:
2N a token plus causal attention) over the admit calls' host time at the
H100's bf16 peak, in %: the whole prefill's share of the chip's peak."""

from benchmark.harness.readers import prefill_mfu


def read(run):
    return prefill_mfu(run)
