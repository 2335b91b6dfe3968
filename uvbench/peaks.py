"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline and MFU share."""

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of operations over
    peak rate and bytes over memory bandwidth."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
