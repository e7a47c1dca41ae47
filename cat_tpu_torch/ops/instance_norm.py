"""Fused instance-norm + affine + activation (port of
``cat_tpu/ops/pallas_norm.py``).

``instance_norm_act`` launches the hand-written CUDA kernel
(``cat_tpu_torch/csrc/instance_norm.cu``) for a CUDA tensor and its plain
PyTorch twin ``instance_norm_act_plain`` for a CPU tensor; there is no
fallback from one to the other.  ``fused_instance_norm_act`` is the
trainable form: kernel forward, and a backward that differentiates the
plain version with recomputed statistics, as ``_fused_bwd`` does in the JAX
package.

Layout: NCHW-contiguous, so each (n, c) plane is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from cat_tpu_torch.ops.nn import instance_norm_f32
from cat_tpu_torch.utils import cuda_build

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# launches of the CUDA kernel since the last reset (a plain integer, so a
# run can show that its main path went through the kernel)
launches = 0


def instance_norm_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version: float32 E[x²] - mean², affine, activation,
    cast back to x's dtype (``instance_norm_act_xla`` in the JAX package)."""
    y = instance_norm_f32(x.float(), scale, bias, eps)
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, 0.01 * y)
    return y.to(x.dtype)


def _lib():
    lib = cuda_build.load("instance_norm")
    if not getattr(lib, "_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        for fn in (lib.cat_inorm_act_bf16, lib.cat_inorm_act_f32):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def instance_norm_act_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("instance_norm_act_cuda needs a contiguous NCHW tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"instance_norm_act_cuda takes bf16 or f32, got {x.dtype}")
    n, c, h, w = x.shape
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor "
                             f"on {x.device}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    hw = h * w
    per16 = 16 // x.element_size()
    vec = int(hw % per16 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    lib = _lib()
    fn = lib.cat_inorm_act_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_act_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                n, c, hw, float(eps), _ACTS[act], vec, stream)
    cuda_build.check(rc, "instance_norm_act")
    launches += 1
    return y


def instance_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Fused instance norm + affine + activation: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, scale, bias, eps, act)
    return instance_norm_act_cuda(x, scale, bias, eps, act)


class _FusedInstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.act = eps, act
        return instance_norm_act(x, scale, bias, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ss, bs = (t.detach().requires_grad_(True) for t in (x, scale, bias))
            y = instance_norm_act_plain(xs, ss, bs, ctx.eps, ctx.act)
            dx, ds, db = torch.autograd.grad(y, (xs, ss, bs), g)
        return dx, ds, db, None, None


def fused_instance_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Trainable fused instance-norm + affine + activation: one-pass forward;
    the backward differentiates the plain version with rematerialised
    statistics, keeping no feature map besides x."""
    return _FusedInstanceNormAct.apply(x, scale, bias, eps, act)
