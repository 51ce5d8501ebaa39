"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

FP32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12         # TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3


def roofline_seconds(ops: float, nbytes: float,
                     flops: float = FP32_FLOPS) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)
