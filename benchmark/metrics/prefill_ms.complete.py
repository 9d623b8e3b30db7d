"""prefill_ms.complete: mean host ms of an admit call (the whole
prefill, ending on the first token's copy to the host)."""

from benchmark.harness.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "admit")
