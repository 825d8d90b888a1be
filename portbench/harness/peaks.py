"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12    # HBM3
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
# 64 INT32 lanes an SM against 128 float32 lanes, whose fused multiply-add
# counts twice in the float32 rate
INT32_OPS_PER_S = FP32_OPS_PER_S / 4


def bound_s(nbytes: float, ops: float, int_ops: float = 0.0) -> float:
    """Least seconds the card could take: the largest of the bytes over the
    memory rate, the float32 operations over the float32 rate and the
    integer operations over the INT32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
