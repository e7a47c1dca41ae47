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

Over a split height (``parallel/spatial.py``) a rank holds its rows of each
plane, and the statistics are the whole plane's: ``instance_norm_act``
then runs the kernel's two passes apart (``instance_norm_act_split``): the
partial sums of each local plane (``plane_sums``), their all-reduce over
the spatial axis, and the normalisation with the global mean and rstd
(``norm_apply``); each has its plain version beside it, and a CUDA tensor
never falls back to them.
"""

from __future__ import annotations

import ctypes

import torch

from cat_tpu_torch.ops.nn import instance_norm_f32
from cat_tpu_torch.parallel import collectives, spatial
from cat_tpu_torch.utils import cuda_build

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# launches of the CUDA kernel since the last reset (a plain integer, so a
# run can show that its main path went through the kernel), and of the
# split planes' two entry points
launches = 0
split_launches = {"stats": 0, "apply": 0}


def instance_norm_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Plain PyTorch version: float32 E[x²] - mean², affine, activation,
    cast back to x's dtype (``instance_norm_act_xla`` in the JAX package)."""
    return _act(instance_norm_f32(x.float(), scale, bias, eps), act).to(x.dtype)


def plane_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split planes' first pass: each (n, c) plane's
    float32 (Σx, Σx²) over x's rows, shaped (N·C, 2)."""
    xf = x.float().flatten(2)
    return torch.stack([xf.sum(2), xf.square().sum(2)], -1).reshape(-1, 2)


def norm_apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Plain version of the split planes' second pass: (x - mean)·rstd per
    plane (float32 (N·C,) each), affine, activation, cast back to x's dtype."""
    n, c = x.shape[:2]
    y = ((x.float() - mean.reshape(n, c, 1, 1)) * rstd.reshape(n, c, 1, 1)
         * scale.float()[:, None, None] + bias.float()[:, None, None])
    return _act(y, act).to(x.dtype)


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, 0.01 * y)
    return y


def _lib():
    lib = cuda_build.load("instance_norm")
    if not getattr(lib, "_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
        for fn in (lib.cat_inorm_act_bf16, lib.cat_inorm_act_f32):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        for fn in (lib.cat_inorm_stats_bf16, lib.cat_inorm_stats_f32):
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                   ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.cat_inorm_apply_bf16, lib.cat_inorm_apply_f32):
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(x: torch.Tensor, what: str, **per_channel) -> None:
    """Raise unless x is a contiguous NCHW bf16/f32 CUDA tensor and every
    named tensor a contiguous float32 one of its length on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous NCHW tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32, got {x.dtype}")
    for name, (p, size) in per_channel.items():
        if (p.dtype != torch.float32 or p.shape != (size,) or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({size},) tensor "
                             f"on {x.device}")


def _vec(x: torch.Tensor, *outs: torch.Tensor) -> int:
    """Whether a plane of x allows 16-byte accesses."""
    hw = x.shape[2] * x.shape[3]
    return int(hw % (16 // x.element_size()) == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *outs)))


def instance_norm_act_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Launch the CUDA kernel; raises on anything it does not take."""
    global launches
    c = x.shape[1] if x.dim() == 4 else 0
    _check(x, "instance_norm_act_cuda", scale=(scale, c), bias=(bias, c))
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    hw = h * w
    vec = _vec(x, y)
    lib = _lib()
    fn = lib.cat_inorm_act_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_act_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                n, c, hw, float(eps), _ACTS[act], vec, stream)
    cuda_build.check(rc, "instance_norm_act")
    launches += 1
    return y


def plane_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the first pass of the split planes (``cat_inorm_stats_*``)."""
    _check(x, "plane_sums_cuda")
    n, c, h, w = x.shape
    stats = torch.empty((n * c, 2), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return stats.zero_()
    lib = _lib()
    fn = lib.cat_inorm_stats_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_stats_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), stats.data_ptr(), n, c, h * w, _vec(x),
                torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "instance_norm stats")
    split_launches["stats"] += 1
    return stats


def norm_apply_cuda(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, act: str = "relu") -> torch.Tensor:
    """Launch the second pass of the split planes (``cat_inorm_apply_*``)."""
    n, c = x.shape[:2] if x.dim() == 4 else (0, 0)
    _check(x, "norm_apply_cuda", mean=(mean, n * c), rstd=(rstd, n * c), scale=(scale, c),
           bias=(bias, c))
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    fn = lib.cat_inorm_apply_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_apply_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), n, c, x.shape[2] * x.shape[3], _ACTS[act],
                _vec(x, y), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "instance_norm apply")
    split_launches["apply"] += 1
    return y


def plane_sums(x: torch.Tensor) -> torch.Tensor:
    """The split planes' first pass: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    return plane_sums_plain(x) if x.device.type == "cpu" else plane_sums_cuda(x)


def norm_apply(x, mean, rstd, scale, bias, act: str = "relu") -> torch.Tensor:
    """The split planes' second pass: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return norm_apply_plain(x, mean, rstd, scale, bias, act)
    return norm_apply_cuda(x, mean, rstd, scale, bias, act)


def instance_norm_act_split(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Fused instance norm over planes whose rows are split over the
    spatial axis: local partial sums, their all-reduce, the global count's
    mean and E[x²] - mean², then the normalising pass."""
    stats = collectives.all_reduce_(plane_sums(x), "spatial")
    count = spatial.count_sum(x.shape[2] * x.shape[3])
    mean = stats[:, 0] / count
    rstd = torch.rsqrt(stats[:, 1] / count - mean.square() + eps)
    return norm_apply(x, mean, rstd, scale, bias, act)


def instance_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Fused instance norm + affine + activation: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; over a split height, the
    split planes' passes (``instance_norm_act_split``)."""
    if spatial.active():
        return instance_norm_act_split(x, scale, bias, eps, act)
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
    """Trainable fused instance-norm + affine + activation: one-pass forward
    (two passes around an all-reduce over a split height); the backward
    differentiates the plain version with rematerialised statistics (over a
    split height, its sums all-reduced), keeping no feature map besides x."""
    return _FusedInstanceNormAct.apply(x, scale, bias, eps, act)
