"""queue_wait_ms.complete: mean time from when a request was due to the
start of its admit call (the request surface's queue), host clock."""

from benchmark.harness.readers import admitted
from benchmark.harness.stats import mean


def read(run):
    rs = admitted(run)
    return mean([(r["admit_t0"] - r["due"]) / 1e6 for r in rs]) if rs else None
