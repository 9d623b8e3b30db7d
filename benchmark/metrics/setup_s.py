"""setup_s: process start to the start of the measured window (imports,
kernel load, weights made on the device, warm-up), host clock."""


def read(run):
    return run.setup_s
