"""Fused instance-norm + affine + activation (port of
``cat_tpu/ops/pallas_norm.py``), and its backward.

``instance_norm_act`` launches the hand-written CUDA kernel
(``cat_tpu_torch/csrc/instance_norm.cu``) for a CUDA tensor and its plain
PyTorch twin ``instance_norm_act_plain`` for a CPU tensor; there is no
fallback from one to the other.  ``norm_plan`` picks the kernel's path by
shape: the plane staged in shared memory by one CTA (``"one_cta"``, small
planes packed several to a CTA), split over a thread-block cluster
(``"cluster"``), or the two-pass loop (``"two_pass"``) for a plane past 8
slices or an unaligned one.  ``fused_instance_norm_act`` is the trainable
form: kernel forward, which also writes each plane's mean and rstd, and the
backward kernel (``instance_norm_act_backward_cuda``) for a CUDA tensor;
its closed-form plain twin ``instance_norm_act_backward_plain`` for a CPU
tensor.  Both differentiate the forward's formula as JAX does
``_fused_bwd``'s, relu's gradient at a tie (½, ``jnp.maximum``'s) included.

Layout: NCHW-contiguous, so each (n, c) plane is contiguous.

Over a split height (``parallel/spatial.py``) a rank holds its rows of each
plane, and the statistics are the whole plane's: ``instance_norm_act``
then runs the kernel's two passes apart (``instance_norm_act_split``): the
partial sums of each local plane (``plane_sums``), their all-reduce over
the spatial axis, and the normalisation with the global mean and rstd
(``norm_apply``); each has its plain version beside it, and a CUDA tensor
never falls back to them.  The backward over a split height differentiates
the plain version, whose sums are all-reduced.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cat_tpu_torch.ops.nn import instance_norm_f32
from cat_tpu_torch.parallel import collectives, spatial
from cat_tpu_torch.utils import cuda_build

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# launches of the CUDA kernel since the last reset (a plain integer, so a
# run can show that its main path went through the kernel), by path; of the
# backward kernel; and of the split planes' two entry points
launches = 0
path_launches = {"one_cta": 0, "cluster": 0, "two_pass": 0}
bwd_launches = 0
bwd_path_launches = {"one_cta": 0, "cluster": 0, "two_pass": 0}
split_launches = {"stats": 0, "apply": 0}

# Measured at the flagship's planes on an H100 (ops/norm_sweep.py): a plane of
# up to 128 KiB runs faster whole in one CTA than split over a cluster, and a
# larger one faster in slices of 64 KiB (three CTAs an SM) than of 128 KiB.
_CTA_BYTES = 128 << 10  # the most one CTA stages of a plane it holds whole
_SLICE_BYTES = 64 << 10  # a cluster's slices
_FILL_BYTES = 32 << 10  # small planes are packed to a CTA until it stages this much
_MAX_CLUSTER = 8  # the portable cluster size
_MAX_PACK = 8  # planes a CTA: each takes whole warps of the 256 threads
_CHUNKS = 4  # bulk copies of a single-plane CTA's slice, one mbarrier each
_MIN_CHUNK_BYTES = 8 << 10


class NormPlan(NamedTuple):
    """How the kernel takes a plane: ``path``; ``k`` CTAs a plane (a
    cluster when > 1); ``ppc`` planes a CTA; ``slice`` values a CTA stages
    of each plane; bulk copies of ``chunk`` values (one mbarrier each)."""
    path: str
    k: int
    ppc: int
    slice: int
    chunk: int


TWO_PASS = NormPlan("two_pass", 0, 1, 0, 0)


def norm_plan(hw: int, itemsize: int, arrays: int = 1, aligned: bool = True) -> NormPlan:
    """The plan for planes of ``hw`` values of ``itemsize`` bytes, ``arrays``
    tensors staged together (1: the forward's x; 2: the backward's x and
    g); ``aligned``: every pointer is 16-byte aligned.  A plane of at most
    128 KiB is one CTA's, packed 2, 4 or 8 to a CTA while a CTA stages
    under 32 KiB; a larger one is split over a cluster of k <= 8 CTAs into
    slices of at most 64 KiB (16-byte multiples, the last one shorter); a
    plane past 8 slices, or one whose bytes or pointers are not 16-byte
    aligned, takes the two-pass loop."""
    row = hw * itemsize
    if not aligned or row % 16 or hw == 0:
        return TWO_PASS
    vec = 16 // itemsize  # values a 16-byte access
    plane = row * arrays
    if plane <= _CTA_BYTES:
        ppc = 1
        while ppc < _MAX_PACK and 2 * ppc * plane <= _FILL_BYTES:
            ppc *= 2
        if ppc > 1:  # one bulk copy a plane
            return NormPlan("one_cta", 1, ppc, hw, hw)
        path, k, slice_ = "one_cta", 1, hw
    else:
        k = -(-plane // _SLICE_BYTES)
        if k > _MAX_CLUSTER:
            return TWO_PASS
        path, slice_ = "cluster", _round_up(-(-hw // k), vec)
    nch = max(1, min(_CHUNKS, slice_ * itemsize * arrays // _MIN_CHUNK_BYTES))
    return NormPlan(path, k, 1, slice_, _round_up(-(-slice_ // nch), vec))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_plan(plan: NormPlan, hw: int, itemsize: int, arrays: int, vec: int) -> None:
    """Raise unless the kernel can take ``plan`` for planes of ``hw`` values
    (a caller may pass its own): the two-pass loop takes any plane; the
    on-chip kernel needs 16-byte accesses, 1-8 CTAs a plane covering it with
    whole 16-byte accesses, 1, 2, 4 or 8 whole planes a CTA only when k is
    1, at most 8 chunks (mbarriers) a CTA, and a CTA's bytes within the
    227 KB an SM gives one."""
    if plan.path == "two_pass":
        return
    v = 16 // itemsize
    ok = (vec and plan.slice > 0 and plan.chunk > 0 and plan.slice % v == 0
          and plan.chunk % v == 0 and 1 <= plan.k <= _MAX_CLUSTER
          and (plan.k - 1) * plan.slice < hw <= plan.k * plan.slice
          and -(-plan.slice // plan.chunk) <= 8
          and plan.ppc * plan.slice * itemsize * arrays <= 227 * 1024
          and (plan.ppc == 1 or (plan.ppc in (2, 4, 8) and plan.k == 1
                                 and plan.slice == plan.chunk == hw)))
    if not ok:
        raise ValueError(f"the norm kernel cannot take {plan} for planes of {hw} values")


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
        # (y + |y|)/2 has max(y, 0)'s values bit for bit, and the gradient
        # JAX gives jnp.maximum(y, 0): 1 above 0, ½ at a tie, 0 below
        return 0.5 * (y + y.abs())
    if act == "leaky_relu":
        return torch.where(y >= 0, y, 0.01 * y)
    return y


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """The activation's derivative at z, as ``_act``'s gradient (and JAX's)."""
    if act == "relu":
        return (z > 0).float() + 0.5 * (z == 0).float()
    if act == "leaky_relu":
        return torch.where(z >= 0, 1.0, 0.01)
    return torch.ones_like(z)


def instance_norm_act_backward_plain(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor, eps: float = 1e-5, act: str = "relu",
                                     stats=None):
    """Plain version of the backward kernel: (dx, dscale, dbias) of
    ``instance_norm_act_plain`` for the upstream gradient g, in closed form
    and float32: xhat = (x - mean)·rstd, z = scale·xhat + bias, g' =
    g·act'(z), dx = scale·rstd·(g' - mean(g') - xhat·mean(g'·xhat)) in x's
    dtype, dbias = Σ g', dscale = Σ g'·xhat over (n, h, w).  ``stats``: the
    forward kernel's (mean, rstd), (N·C,) float32 each, in place of
    recomputing them, so that a comparison with the kernel evaluates relu's
    mask on the same z bit for bit (a z within a rounding of 0 flips it)."""
    xf, gf = x.float(), g.float()
    if stats is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        rstd = torch.rsqrt(xf.square().mean(dim=(2, 3), keepdim=True) - mean.square() + eps)
    else:
        mean, rstd = (t.reshape(x.shape[0], x.shape[1], 1, 1) for t in stats)
    sc, bi = scale.float()[:, None, None], bias.float()[:, None, None]
    xh = (xf - mean) * rstd
    gp = gf * _act_grad(xh * sc + bi, act)
    s1, s2 = gp.sum(dim=(2, 3), keepdim=True), (gp * xh).sum(dim=(2, 3), keepdim=True)
    n = x.shape[2] * x.shape[3]
    dx = sc * rstd * (gp - s1 / n - xh * (s2 / n))
    return dx.to(x.dtype), s2.sum(dim=(0, 2, 3)), s1.sum(dim=(0, 2, 3))


def _lib():
    lib = cuda_build.load("instance_norm")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        plan = [i, i, ll, ll, i, p]  # k, ppc, slice, chunk, vec, stream
        for fn in (lib.cat_inorm_act_bf16, lib.cat_inorm_act_f32):
            fn.argtypes = [p] * 6 + [ll, i, ll, ctypes.c_float, i] + plan
            fn.restype = i
        for fn in (lib.cat_inorm_act_bwd_bf16, lib.cat_inorm_act_bwd_f32):
            fn.argtypes = [p] * 10 + [i, i, ll, i] + plan
            fn.restype = i
        for fn in (lib.cat_inorm_stats_bf16, lib.cat_inorm_stats_f32):
            fn.argtypes = [p] * 2 + [i, i, ll, i, p]
            fn.restype = i
        for fn in (lib.cat_inorm_apply_bf16, lib.cat_inorm_apply_f32):
            fn.argtypes = [p] * 6 + [i, i, ll, i, i, p]
            fn.restype = i
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
    return forward_cuda(x, scale, bias, eps, act)[0]


def forward_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                 act: str = "relu", plan: NormPlan = None):
    """Launch the CUDA kernel on the path ``norm_plan`` picks (or on
    ``plan``: any plane takes ``TWO_PASS``); returns y and each plane's
    float32 mean and rstd, (N·C,) each."""
    global launches
    c = x.shape[1] if x.dim() == 4 else 0
    _check(x, "instance_norm_act_cuda", scale=(scale, c), bias=(bias, c))
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(n * c, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    vec = _vec(x, y)
    plan = plan or norm_plan(h * w, x.element_size(), 1, bool(vec))
    _check_plan(plan, h * w, x.element_size(), 1, vec)
    lib = _lib()
    fn = lib.cat_inorm_act_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_act_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), n * c, c, h * w, float(eps), _ACTS[act], plan.k, plan.ppc,
                plan.slice, plan.chunk, vec, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "instance_norm_act")
    launches += 1
    path_launches[plan.path] += 1
    return y, mean, rstd


def instance_norm_act_backward_cuda(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                                    rstd: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                    act: str = "relu", plan: NormPlan = None):
    """Launch the backward kernel (on ``norm_plan``'s path for x and g
    together, or on ``plan``) with the forward's mean and rstd; returns
    (dx, dscale, dbias).  Raises on anything it does not take."""
    global bwd_launches
    n, c = x.shape[:2] if x.dim() == 4 else (0, 0)
    _check(x, "instance_norm_act_backward_cuda", mean=(mean, n * c), rstd=(rstd, n * c),
           scale=(scale, c), bias=(bias, c))
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError("the upstream gradient must be a contiguous tensor of x's shape, "
                         "dtype and device")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    h, w = x.shape[2:]
    dx = torch.empty_like(x)
    dscale = torch.zeros(c, dtype=torch.float32, device=x.device)
    dbias = torch.zeros_like(dscale)
    if x.numel() == 0:
        return dx, dscale, dbias
    sums = torch.empty((n * c, 2), dtype=torch.float32, device=x.device)
    vec = _vec(x, g, dx)
    plan = plan or norm_plan(h * w, x.element_size(), 2, bool(vec))
    _check_plan(plan, h * w, x.element_size(), 2, vec)
    lib = _lib()
    fn = lib.cat_inorm_act_bwd_bf16 if x.dtype == torch.bfloat16 else lib.cat_inorm_act_bwd_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), dx.data_ptr(), sums.data_ptr(), dscale.data_ptr(),
                dbias.data_ptr(), n, c, h * w, _ACTS[act], plan.k, plan.ppc, plan.slice,
                plan.chunk, vec, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "instance_norm_act backward")
    bwd_launches += 1
    bwd_path_launches[plan.path] += 1
    return dx, dscale, dbias


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
        ctx.eps, ctx.act = eps, act
        if spatial.active() or x.device.type == "cpu":
            ctx.save_for_backward(x, scale, bias)
            return instance_norm_act(x, scale, bias, eps, act)
        y, mean, rstd = forward_cuda(x, scale, bias, eps, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, *stats = ctx.saved_tensors
        if stats:
            dx, ds, db = instance_norm_act_backward_cuda(
                x, g.to(x.dtype).contiguous(), *stats, scale, bias, ctx.act)
        elif not spatial.active():
            dx, ds, db = instance_norm_act_backward_plain(x, g, scale, bias, ctx.eps, ctx.act)
        else:  # the plain version, its sums all-reduced over the split height
            with torch.enable_grad():
                xs, ss, bs = (t.detach().requires_grad_(True) for t in (x, scale, bias))
                y = instance_norm_act_plain(xs, ss, bs, ctx.eps, ctx.act)
                dx, ds, db = torch.autograd.grad(y, (xs, ss, bs), g)
        return dx, ds.to(scale.dtype), db.to(bias.dtype), None, None


def fused_instance_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, act: str = "relu") -> torch.Tensor:
    """Trainable fused instance-norm + affine + activation: one-pass forward
    (two passes around an all-reduce over a split height); the backward
    kernel on the forward's saved mean and rstd (its closed-form plain twin
    on the CPU; over a split height, the plain version differentiated with
    its sums all-reduced), keeping no feature map besides x."""
    return _FusedInstanceNormAct.apply(x, scale, bias, eps, act)
