"""decode_stall_share.complete: the share of live rows' time spent
stalled behind a synchronous prefill: the sum over ``serving.admit`` spans
of length times ``live_rows`` (rows live when it began) over that plus
the same sum over ``serving.step`` spans, in % (the program's counters,
untraced part of the window)."""

from benchmark.harness.program_spans import stall_share


def read(run):
    return stall_share(run)
