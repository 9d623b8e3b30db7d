"""optimizer_ms.train: device ms a step of the operations launched inside
the span the benchmark opens around ``AdamW.update_`` (traced runs)."""

from benchmark.harness.readers import optimizer_ms


def read(run):
    return optimizer_ms(run)
