"""tpot_p95_ms.complete: 95th percentile over every gap between
consecutive tokens of every request, host clock (a token is on the host
when the call that made it returns: ``admit`` for the first, ``step`` for
each later one; in a traced run, the gaps that closed before the profiler
started). A gap holds every synchronous prefill admitted between the two
steps, and a decode stall also holds back the admissions queued behind
it, so it is read beside ``ttft_p95_ms``."""

from benchmark.harness.readers import p95, token_gaps_ms


def read(run):
    return p95(token_gaps_ms(run)) if run.requests else None
