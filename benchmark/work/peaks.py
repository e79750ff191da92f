"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): HBM3 bandwidth and the float32 rate
outside the tensor cores, which the port's float32 kernels use."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_seconds(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """The least time of a call: max(bytes / bandwidth, FLOPs / peak rate)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)
