"""flash_bwd_roofline.train: the flash backward kernels' share of their
roofline over the traced window: per backward (one layer and micro-batch)
the larger of 2.5 times the forward's FLOPs over 989 TFLOP/s and q, k, v,
dO, lse, delta, dq, dk, dv once over 3.35 TB/s (``harness/flops``),
summed, over the summed device time of ``flash_bwd_dkdv_wgmma`` and
``flash_bwd_dq_wgmma``, in %."""

from benchmark.harness.flops import flash_bwd_traffic
from benchmark.harness.readers import flash_roofline


def read(run):
    return flash_roofline(run, ["flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"],
                          flash_bwd_traffic)
