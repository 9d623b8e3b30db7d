"""forward_ms.train: device ms a train step of the operations launched
inside the program's ``train.forward`` spans (forward and loss; traced
part of the window)."""

from benchmark.harness.program_spans import device_ms_per


def read(run):
    return device_ms_per(run, "train.step", "train.forward")
