"""backward_ms.train: device ms a train step of the operations launched
inside the program's ``train.backward`` spans (the gradient) and
``train.reduce`` spans (accumulation over micro-batches, the all-reduce
over a mesh; none in a one-card step without accumulation), traced part
of the window."""

from benchmark.harness.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "train.step", "train.backward", "train.reduce")
