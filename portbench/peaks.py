"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W), and
the least time of a piece of work against them."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores


def least_time(nbytes: float, flops: float) -> float:
    """Seconds the card needs at least: bytes over bandwidth or operations
    over the FP32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
