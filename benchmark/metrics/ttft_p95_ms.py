"""ttft_p95_ms: 95th percentile, over every request due in the window,
of the time from when it was due to its first token on the host; a
request with no first token by the window's end counts with its wait so
far. Host clock."""

from benchmark.harness.readers import p95, ttft_ms


def read(run):
    return p95(ttft_ms(run)) if run.requests else None
