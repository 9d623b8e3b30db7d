"""train_mfu: model FLOPs of the window's steps (6N a token plus causal
attention's forward and backward) over the window at the H100's bf16
peak, in %: the whole step's share of the chip's peak."""

from benchmark.harness.readers import train_mfu


def read(run):
    return train_mfu(run)
