"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM5 80GB data sheet, dense rates without sparsity, at the
full 700 W power limit (a card set lower runs slower under load; each run
records the card's limit on standard error)."""

H100_SXM = {
    "bf16_flops": 989e12,
    "fp16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}


def peak(kind: str) -> float:
    return H100_SXM[kind]


def bound_s(flops: float, nbytes: float, flops_kind: str = "bf16_flops"):
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / H100_SXM[flops_kind],
               nbytes / H100_SXM["hbm_bytes_per_s"])
