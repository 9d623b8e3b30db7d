"""flash_fwd_roofline.train: the flash forward kernel's share of its
roofline over the traced window: per launch (one layer and micro-batch)
the larger of 4 b n h s(s+1)/2 FLOPs over 989 TFLOP/s and q, k, v, o and
the lse once over 3.35 TB/s (``harness/flops``), summed, over the summed
device time of ``flash_fwd_wgmma``, in %."""

from benchmark.harness.flops import flash_fwd_traffic
from benchmark.harness.readers import flash_roofline


def read(run):
    return flash_roofline(run, ["flash_fwd_wgmma"], flash_fwd_traffic)
