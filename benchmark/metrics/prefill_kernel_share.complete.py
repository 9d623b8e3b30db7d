"""prefill_kernel_share.complete: the share of admissions whose prefill
attention ran through the flash kernel: the mean of the program's
``self_attn_kernel`` counter over the ``serving.admit.forward`` spans that
carry it, in % (untraced part of the window). None where no span carries
the counter, as in a program that does not count it."""

from benchmark.harness.program_spans import host_part, named


def read(run):
    counts = [s.info["self_attn_kernel"]
              for s in named(host_part(run) or [], "serving.admit.forward")
              if "self_attn_kernel" in s.info]
    if not counts:
        return None
    return 100.0 * sum(counts) / len(counts)
