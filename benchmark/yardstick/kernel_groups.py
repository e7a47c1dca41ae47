"""Kernel groups by name (frozen): each CUDA kernel of a trace falls in the
first group one of whose substrings its lower-cased name holds, else in
"other".  The names are those of the port's hand-written kernels
(``csrc/gram.cu``, ``csrc/instance_norm.cu``) and of the kernels cuDNN,
cuBLAS and ATen launch for it."""

from __future__ import annotations

GRAM = "gram (csrc/gram.cu)"
NORM_BWD = "instance_norm_act backward (csrc/instance_norm.cu)"
NORM_FWD = "instance_norm_act forward (csrc/instance_norm.cu)"
TRANSPOSE = "cuDNN NCHW<->NHWC transposes"
CONV = "convolution / matmul"
PAD = "reflection pad"
ADAM = "multi-tensor (Adam)"
REDUCTION = "reduction (plain norm statistics, losses)"
ELEMENTWISE = "elementwise / copy / cast"
OTHER = "other"

GROUPS = (
    (GRAM, ("gram_partial", "gram_reduce")),
    (NORM_BWD, ("inorm_act_bwd", "inorm_bwd")),
    (NORM_FWD, ("inorm_act",)),
    (TRANSPOSE, ("nchwtonhwc", "nhwctonchw")),
    (CONV, ("conv", "gemm", "xmma", "sm90_", "sm80_", "cutlass", "cudnn", "dgrad", "wgrad")),
    (PAD, ("reflection_pad",)),
    (ADAM, ("multi_tensor", "foreach")),
    (REDUCTION, ("reduce",)),
    (ELEMENTWISE, ("elementwise", "copy", "cat", "fill")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return OTHER
