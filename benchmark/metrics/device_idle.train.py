"""device_idle.train: share of the traced window in which no kernel,
copy or fill ran on the card, in %."""

from benchmark.harness.readers import device_idle


def read(run):
    return device_idle(run)
