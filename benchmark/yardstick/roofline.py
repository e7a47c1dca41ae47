"""Peaks of the card and the least time a kernel could take (frozen).

Published figures of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates, no sparsity).  A share of a roofline or of a peak is
stated against these, with the card's power limit recorded beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# dense operations a second by the precision an operation runs in;
# "float32" is the CUDA cores' FMA rate (the float32 Gram kernel's)
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "int8": 1979e12,
}

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def gram_bound_s(b: int, f: int, dtype: str) -> float:
    """A Gram of a (b, f) operand: the larger of X read once and G written
    once over HBM's rate, and its lower triangle's b(b+1)·f operations over
    the operand dtype's peak (bf16 on the tensor cores, float32 on the CUDA
    cores)."""
    bytes_s = (b * f * ITEMSIZE[dtype] + b * b * 4) / HBM_BYTES_PER_S
    ops_s = b * (b + 1) * f / PEAK_FLOPS[dtype]
    return max(bytes_s, ops_s)


def norm_forward_bound_s(values: int, dtype: str) -> float:
    """The fused instance norm's forward over ``values`` elements: x read
    and y written once, or ~10 float32 operations an element on the CUDA
    cores, whichever is longer."""
    return max(2 * values * ITEMSIZE[dtype] / HBM_BYTES_PER_S,
               10 * values / PEAK_FLOPS["float32"])


def norm_backward_bound_s(values: int, dtype: str) -> float:
    """Its backward: x and the incoming gradient read and dx written once,
    or ~20 float32 operations an element."""
    return max(3 * values * ITEMSIZE[dtype] / HBM_BYTES_PER_S,
               20 * values / PEAK_FLOPS["float32"])
