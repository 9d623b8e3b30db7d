"""decode_step_ms.complete: mean host ms of a step() call (every live
request advanced one token; it ends synced)."""

from benchmark.harness.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "step")
