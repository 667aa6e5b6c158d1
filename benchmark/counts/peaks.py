"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(ops / peak_ops, nbytes / HBM_BYTES_PER_S)
