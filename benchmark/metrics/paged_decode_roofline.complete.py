"""paged_decode_roofline.complete: the paged-decode kernel's share of its
roofline over the traced window: for each launch, the larger of its bytes
over 3.35 TB/s and its FLOPs over 989 TFLOP/s (``harness/paged_traffic``,
at the live lengths), summed, over the summed device time of
``paged_split_kernel``, in %."""

from benchmark.harness.readers import paged_decode_roofline


def read(run):
    return paged_decode_roofline(run)
