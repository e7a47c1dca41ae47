"""GroupNorm + affine, then optionally a per-sample scale-shift and SiLU
(ADM's AdaGN chain), and its backward.

``group_norm_act`` is the trainable form ADM's ``GroupNorm32`` calls: on a
CUDA tensor the hand-written kernels of ``cat_tpu_torch/csrc/group_norm.cu``
forward and backward, on a CPU tensor the plain twin
``group_norm_act_plain`` and its closed-form backward
``group_norm_act_backward_plain``; there is no fallback from one to the
other.  For x of shape (N, C, ...) and ``groups`` G:

    y = GroupNorm(x) with float32 statistics (centred, biased) and the
        float32 affine γ, β;
    u = y·(1 + scale) + shift, scale and shift the first and second C
        columns of ``emb`` (N, 2C) (the timestep linear's output, read in
        place), or u = y without ``emb``;
    out = SiLU(u) with ``silu``, else u; rounded once to x's dtype.

The kernels follow x's layout, which the op observes: a contiguous (N, C,
...) x takes the NCHW kernels, an x stored channels innermost (a
``channels_last`` tensor, or an (N, C, T) view of an (N, T, C) tensor) the
NHWC kernels, with the output, the gradient and dx in that layout; any
other layout raises (no copy to another).  ``group_norm_plan`` picks the
NCHW kernel's path by shape: the slab of a group staged whole in one CTA
(``"cta"``), split over a thread-block cluster (``"cluster"``), or two
passes over device memory with one CTA a piece of a channel (``"split"``).
``group_norm_nhwc_plan`` picks the NHWC kernels' unit (a sample and a run
of whole groups) and the same three paths for it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cat_tpu_torch.utils import cuda_build

# launches of the forward since the last reset (a plain integer, so a run can
# show that its main path went through the kernel), by path; of the backward
launches = 0
path_launches = {"cta": 0, "cluster": 0, "split": 0}
bwd_launches = 0
# launches of the forward and the backward together, by x's layout
layout_launches = {"nchw": 0, "nhwc": 0}

_SLICE_BYTES = 64 << 10  # the most a CTA stages: three CTAs of 512 threads an SM
_MAX_CLUSTER = 16  # the most a (non-portable) cluster takes on an H100
# Measured at the ADM cell's slabs on an H100 (batch 16, bf16, each path
# timed alone after an L2 flush): a cluster beats the split path
# forward up to 16 CTAs (1 MiB slabs: 0.574 against 0.677 ms), but backward
# only up to 8 (8: 0.258 against 0.270 ms; 12: 0.437 against 0.386; 16:
# 0.530 against 0.499)
_BWD_MAX_CLUSTER = 8
_MAX_SEGS = 64  # channels a staged CTA touches
_CHUNKS = 4  # bulk copies of a slice, one mbarrier each
_MIN_CHUNK_BYTES = 8 << 10
_SPLIT_PIECE = 8192  # values a CTA of the split path


class GroupNormPlan(NamedTuple):
    """How the kernels take a slab: ``path``; ``k`` CTAs a slab (a cluster
    when > 1; 0 on the split path); ``slice`` values a CTA (a piece of a
    channel on the split path); bulk copies of ``chunk`` values (one
    mbarrier each); ``pieces`` a channel is cut into (1 where a CTA holds
    whole channels)."""
    path: str
    k: int
    slice: int
    chunk: int
    pieces: int


@functools.lru_cache(maxsize=None)
def group_norm_plan(cpg: int, hw: int, itemsize: int, arrays: int = 1,
                    aligned: bool = True) -> GroupNormPlan:
    """The plan for groups of ``cpg`` channels of ``hw`` values of
    ``itemsize`` bytes, ``arrays`` tensors staged together (1: the forward's
    x; 2: the backward's x and g); ``aligned``: every pointer is 16-byte
    aligned.  A slab of at most 64 KiB is one CTA's; a larger one is split
    over a cluster of at most 16 CTAs forward and 8 backward that each stage
    at most 64 KiB, whole channels or an equal piece of one channel;
    anything else, or a slab with more than 64 channels, or one whose
    channels do not start on 16 bytes, takes the split path."""
    max_cluster = _MAX_CLUSTER if arrays == 1 else _BWD_MAX_CLUSTER
    vec = 16 // itemsize
    if aligned and hw % vec == 0 and cpg <= _MAX_SEGS:
        plan = _staged(cpg, hw, itemsize, arrays, vec, max_cluster)
        if plan is not None:
            return plan
    v = vec if aligned and hw % vec == 0 else 1
    piece = _round_up(min(hw, _SPLIT_PIECE), v)
    return GroupNormPlan("split", 0, piece, 0, -(-hw // piece))


def _staged(cpg, hw, itemsize, arrays, vec, max_cluster) -> Optional[GroupNormPlan]:
    if cpg * hw * itemsize * arrays <= _SLICE_BYTES:
        return _chunked("cta", 1, cpg * hw, 1, itemsize, arrays, vec)
    chan = hw * itemsize * arrays
    if chan <= _SLICE_BYTES:  # whole channels a CTA
        k = -(-cpg // (_SLICE_BYTES // chan))
        slice_, pieces = -(-cpg // k) * hw, 1
        k = -(-cpg * hw // slice_)
    else:  # equal pieces of one channel a CTA
        pieces = -(-chan // _SLICE_BYTES)
        while hw % pieces or (hw // pieces) % vec:
            pieces += 1
        slice_, k = hw // pieces, cpg * pieces
    if k > max_cluster:
        return None
    return _chunked("cluster", k, slice_, pieces, itemsize, arrays, vec)


def _chunked(path, k, slice_, pieces, itemsize, arrays, vec) -> GroupNormPlan:
    nch = max(1, min(_CHUNKS, slice_ * itemsize * arrays // _MIN_CHUNK_BYTES))
    return GroupNormPlan(path, k, slice_, _round_up(-(-slice_ // nch), vec), pieces)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


_NHWC_SLICE = 64 << 10  # bytes of each array a staged CTA holds at most
# A staged sample takes a CTA for each 16 KiB of x, at most 8 forward and 4
# backward; a split one H·W / `run` runs of pixels, within [fewest, most]
# (16 runs a sample over ADM's batch of 16 fill the card about once).
# Measured on an H100 at ADM's sites against 1-16 CTAs a staged sample and
# 4-48 runs a split one.
_NHWC_STAGED_BYTES = 16 << 10
_NHWC_MAX_CLUSTER = {1: 8, 2: 4}
_NHWC_SPLIT = {1: (32, 1, 16), 2: (512, 4, 16)}  # (run, fewest, most)
_NHWC_MAX_VECS = 256  # 16-byte vectors of a unit's pixel: one a thread
_NHWC_MAX_GROUPS = 256  # groups of a unit: the kernels' arrays
_NHWC_MAX_PARTS = 2048  # a split unit's groups times its runs: the forward's array


class NhwcPlan(NamedTuple):
    """How the NHWC kernels take x: ``path`` ("cta", "cluster" or
    "split"); units of ``wc`` channels (whole groups, whole 16-byte
    vectors; all C where they fit) of one sample; ``k`` CTAs a unit (a
    cluster when k > 1 on a staged path; the split path's runs of pixels),
    each of ``rows`` pixels (the last run may be shorter); ``chunk``:
    pixels of a bulk copy on a staged path, 0 on the split path."""
    path: str
    wc: int
    k: int
    rows: int
    chunk: int


@functools.lru_cache(maxsize=None)
def group_norm_nhwc_plan(n: int, c: int, cpg: int, hw: int, itemsize: int,
                         arrays: int = 1) -> NhwcPlan:
    """The plan for an (N, H·W, C) x of ``itemsize`` bytes in groups of
    ``cpg`` channels, ``arrays`` tensors read together (1: the forward's x;
    2: the backward's x and g).  A unit is a sample's pixels over all C
    channels where C is at most 256 vectors (so a CTA's pixels are one
    contiguous run of memory, read in whole lines).  A sample is staged by
    bulk copies over a cluster of a CTA a 16 KiB of it, at most 8 (4
    backward), that split its pixels evenly into at most 64 KiB of each
    array; anything else takes the split path in H·W/32 runs of pixels,
    1-16 of them (backward H·W/512, 4-16).  Raises where C is not whole
    16-byte vectors or a group is wider than 256 vectors."""
    vec = 16 // itemsize
    if c % vec:
        raise ValueError(f"the NHWC kernels need C a multiple of {vec} for {itemsize}-byte "
                         f"values, got {c}")
    wc = _unit_width(c, cpg, vec)
    sample = hw * c * itemsize
    if wc == c:
        most = _NHWC_MAX_CLUSTER[arrays]
        want = min(most, max(1, sample // _NHWC_STAGED_BYTES))
        k = next((k for k in range(want, most + 1) if hw % k == 0), 0)
        if k and sample // k <= _NHWC_SLICE:
            rows = hw // k
            chunks = max(1, min(4, sample // k // (8 << 10)))  # bulk copies of >= 8 KiB
            return NhwcPlan("cta" if k == 1 else "cluster", c, k, rows, -(-rows // chunks))
    run, fewest, most = _NHWC_SPLIT[arrays]
    k = min(most, max(fewest, hw // run), hw, _NHWC_MAX_PARTS // (wc // cpg))
    rows = -(-hw // k)
    return NhwcPlan("split", wc, -(-hw // rows), rows, 0)


def _unit_width(c: int, cpg: int, vec: int) -> int:
    """The most channels of whole groups and whole vectors, dividing C, of
    at most 256 vectors and 256 groups; raises where there are none."""
    step = cpg * vec // math.gcd(cpg, vec)
    fits = [m for m in range(step, c + 1, step) if c % m == 0 and m <= _NHWC_MAX_VECS * vec
            and m // cpg <= _NHWC_MAX_GROUPS]
    if not fits:
        raise ValueError(f"the NHWC kernels take units of at most {_NHWC_MAX_VECS} vectors; "
                         f"{cpg} channels a group in {vec}-value vectors need more")
    return fits[-1]


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def _acc(x: torch.Tensor) -> torch.dtype:
    """The dtype the twin computes in: float32, or float64 for a float64 x."""
    return torch.promote_types(x.dtype, torch.float32)


def group_norm_act_plain(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5, emb: Optional[torch.Tensor] = None,
                         silu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``F.group_norm`` in float32 with the affine's
    own tensors, the scale-shift and SiLU in float32, one cast to x's dtype."""
    acc = _acc(x)
    y = F.group_norm(x.to(acc), groups, weight.to(acc), bias.to(acc), eps)
    if emb is not None:
        c = x.shape[1]
        e = emb.to(acc).reshape(x.shape[0], 2 * c, *([1] * (x.dim() - 2)))
        y = y * (1 + e[:, :c]) + e[:, c:]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_act_backward_plain(x: torch.Tensor, g: torch.Tensor, groups: int,
                                  weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                                  emb: Optional[torch.Tensor] = None, silu: bool = False):
    """Plain version of the backward: (dx, dweight, dbias, demb) of
    ``group_norm_act_plain`` for the upstream gradient g, in closed form, in
    float32 (float64 for a float64 x).  With a = γ(1 + scale), du =
    g·SiLU'(u), P = Σ du and Q = Σ du·x̂ over each channel's values:
    dx = rstd·(a·du - (Σ_c a·P + x̂·Σ_c a·Q)/M) (sums over the group's
    channels, M its values), dγ = Σ_n (1 + scale)·Q, dβ = Σ_n (1 + scale)·P,
    d scale = γ·Q + β·P, d shift = P (demb None without ``emb``)."""
    acc = _acc(x)
    n, c = x.shape[:2]
    xf = x.to(acc).reshape(n, groups, -1)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xh = ((xf - mean) * rstd).reshape(n, c, -1)
    w, b = weight.to(acc)[:, None], bias.to(acc)[:, None]
    if emb is not None:
        e = emb.to(acc)
        scale, shift = 1 + e[:, :c], e[:, c:, None]  # (N, C), (N, C, 1)
    else:
        scale = torch.ones((n, c), dtype=acc, device=x.device)
        shift = torch.zeros((), dtype=acc, device=x.device)
    du = g.to(acc).reshape(n, c, -1)
    if silu:
        u = (xh * w + b) * scale[..., None] + shift
        sg = torch.sigmoid(u)
        du = du * sg * (1 + u * (1 - sg))
    p, q = du.sum(-1), (du * xh).sum(-1)  # (N, C)
    a = w[:, 0] * scale  # (N, C)
    s1 = (a * p).reshape(n, groups, -1).sum(-1)[:, :, None]
    s2 = (a * q).reshape(n, groups, -1).sum(-1)[:, :, None]
    m = xf.shape[-1]
    dx = rstd * ((a[..., None] * du).reshape(n, groups, -1)
                 - (s1 + xh.reshape(n, groups, -1) * s2) / m)
    dweight, dbias = (scale * q).sum(0), (scale * p).sum(0)
    demb = None
    if emb is not None:
        demb = torch.cat([w[:, 0] * q + b[:, 0] * p, p], 1).to(emb.dtype)
    return (dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype),
            demb)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = cuda_build.load("group_norm")
    if not getattr(lib, "_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        plan = [i, ll, ll, i, i, p]  # k, slice, chunk, pieces, vec, stream
        for fn in (lib.cat_group_norm_fwd_bf16, lib.cat_group_norm_fwd_f32):
            fn.argtypes = [p] * 8 + [i, i, i, ll, f, i] + plan
            fn.restype = i
        for fn in (lib.cat_group_norm_bwd_bf16, lib.cat_group_norm_bwd_f32):
            fn.argtypes = [p] * 12 + [i, i, i, ll, i] + plan
            fn.restype = i
        nhwc = [i, i, i, i, p]  # wc, k, rows, chunk, stream
        for fn in (lib.cat_group_norm_nhwc_fwd_bf16, lib.cat_group_norm_nhwc_fwd_f32):
            fn.argtypes = [p] * 8 + [i, i, i, i, f, i] + nhwc
            fn.restype = i
        for fn in (lib.cat_group_norm_nhwc_bwd_bf16, lib.cat_group_norm_nhwc_bwd_f32):
            fn.argtypes = [p] * 12 + [i, i, i, i, i] + nhwc
            fn.restype = i
        lib._typed = True
    return lib


def layout(x: torch.Tensor) -> Optional[str]:
    """x's layout as the kernels take it: "nchw" (contiguous), "nhwc"
    (channels innermost: ``x.movedim(1, -1)`` contiguous), else None.  A
    tensor that is both (one value a channel) is "nchw"."""
    if x.is_contiguous():
        return "nchw"
    if x.dim() == 4:  # PyTorch's own check is the cheapest on the host
        return "nhwc" if x.is_contiguous(memory_format=torch.channels_last) else None
    shape, stride = x.shape, x.stride()
    if x.dim() < 3 or stride[1] != 1:
        return None
    want = shape[1]  # dense in (N, *spatial, C) order: what movedim(1, -1) makes contiguous
    for d in range(x.dim() - 1, 1, -1):
        if shape[d] != 1 and stride[d] != want:
            return None
        want *= shape[d]
    return "nhwc" if shape[0] == 1 or stride[0] == want else None


def _in_layout(t: torch.Tensor, lay: str) -> torch.Tensor:
    """t in the layout ``lay`` (no copy where it already is)."""
    return t.contiguous() if lay == "nchw" else t.movedim(1, -1).contiguous().movedim(-1, 1)


def _check(x: torch.Tensor, groups: int, weight, bias, emb, what: str) -> str:
    """Raise unless x is an (N, C, ...) bf16/f32 CUDA tensor, contiguous or
    stored channels innermost (then with whole 16-byte vectors of channels
    from a 16-byte-aligned address, and N·H·W < 2^31), with C a multiple of
    ``groups``, γ and β contiguous float32 (C,) tensors and ``emb`` None or
    a contiguous (N, 2C) tensor of x's dtype, all on x's device; returns
    x's layout."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    lay = layout(x) if x.dim() >= 2 else None
    if lay is None:
        raise ValueError(f"{what} needs an (N, C, ...) tensor, contiguous or stored channels "
                         f"innermost")
    if lay == "nhwc" and (x.shape[1] * x.element_size() % 16 or x.data_ptr() % 16
                          or x.numel() // x.shape[1] >= 2 ** 31):
        raise ValueError(f"{what} on channels innermost needs C·itemsize a multiple of 16 "
                         f"bytes, a 16-byte-aligned tensor and N·H·W < 2^31")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32, got {x.dtype}")
    n, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"{what}: {c} channels do not split into {groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor on {x.device}")
    if emb is not None and (emb.shape != (n, 2 * c) or emb.dtype != x.dtype
                            or not emb.is_contiguous() or emb.device != x.device):
        raise ValueError(f"the scale-shift must be a contiguous ({n}, {2 * c}) tensor of "
                         f"{x.dtype} on {x.device}")
    return lay


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """Whether a channel of x allows 16-byte accesses."""
    hw = math.prod(x.shape[2:])
    return int(hw % (16 // x.element_size()) == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def forward_cuda(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5, emb: Optional[torch.Tensor] = None, silu: bool = False):
    """Launch the forward for x's layout, on the path ``group_norm_plan``
    (NCHW) or ``group_norm_nhwc_plan`` picks; returns the output, in x's
    layout, and each group's float32 mean and rstd, (N, G) each.  Raises on
    anything the kernels do not take."""
    lay = _check(x, groups, weight, bias, emb, "group_norm_act forward")
    n, c = x.shape[:2]
    hw, cpg = math.prod(x.shape[2:]), c // groups
    y = torch.empty_like(x)  # x's strides
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    if lay == "nhwc":
        plan = group_norm_nhwc_plan(n, c, cpg, hw, x.element_size(), 1)
        parts = (torch.empty((n * groups * plan.k, 2), dtype=torch.float32, device=x.device)
                 if plan.path == "split" else None)
        lib = _lib()
        fn = (lib.cat_group_norm_nhwc_fwd_bf16 if x.dtype == torch.bfloat16
              else lib.cat_group_norm_nhwc_fwd_f32)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(emb), y.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), _ptr(parts), n, c, cpg, hw, float(eps),
                    int(silu), plan.wc, plan.k, plan.rows, plan.chunk,
                    torch.cuda.current_stream(x.device).cuda_stream)
        return _launched(rc, "group_norm_act forward", lay, plan.path, y, mean, rstd)
    vec = _vec(x, y)
    plan = group_norm_plan(cpg, hw, x.element_size(), 1, bool(vec))
    parts = (torch.empty((n * c * plan.pieces, 2), dtype=torch.float32, device=x.device)
             if plan.path == "split" else None)
    lib = _lib()
    fn = lib.cat_group_norm_fwd_bf16 if x.dtype == torch.bfloat16 else lib.cat_group_norm_fwd_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(emb), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), _ptr(parts), n, c, cpg, hw, float(eps),
                int(silu), plan.k, plan.slice, plan.chunk, plan.pieces, vec,
                torch.cuda.current_stream(x.device).cuda_stream)
    return _launched(rc, "group_norm_act forward", lay, plan.path, y, mean, rstd)


def _launched(rc: int, what: str, lay: str, path: Optional[str], *out):
    """Raise on a failed launch, else count it (forward: ``path`` given)
    and return ``out``."""
    global launches, bwd_launches
    cuda_build.check(rc, what)
    layout_launches[lay] += 1
    if path is None:
        bwd_launches += 1
    else:
        launches += 1
        path_launches[path] += 1
    return out


def backward_cuda(x: torch.Tensor, g: torch.Tensor, groups: int, mean: torch.Tensor,
                  rstd: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  emb: Optional[torch.Tensor] = None, silu: bool = False):
    """Launch the backward for x's layout (on the plan's path for x and g
    together; g in x's layout) with the forward's mean and rstd; returns
    (dx, dweight, dbias, demb), dx in x's layout, demb None without
    ``emb``.  Raises on anything the kernels do not take."""
    lay = _check(x, groups, weight, bias, emb, "group_norm_act backward")
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or layout(g) != lay
            or (lay == "nhwc" and g.data_ptr() % 16)):
        raise ValueError("the upstream gradient must be a tensor of x's shape, dtype, device "
                         "and layout (16-byte aligned channels innermost)")
    n, c = x.shape[:2]
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.shape != (n, groups) or not t.is_contiguous():
            raise ValueError(f"{name} must be the forward's contiguous float32 ({n}, {groups})")
    hw, cpg = math.prod(x.shape[2:]), c // groups
    dx = torch.empty_like(x)  # x's strides
    if x.numel() == 0:
        return (dx, torch.zeros_like(weight), torch.zeros_like(bias),
                None if emb is None else torch.zeros_like(emb))
    # every element of these is written by the kernels' last pass
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    demb = None if emb is None else torch.empty_like(emb)
    if lay == "nhwc":
        plan = group_norm_nhwc_plan(n, c, cpg, hw, x.element_size(), 2)
        parts = torch.empty((n * c * plan.k, 2), dtype=torch.float32, device=x.device)
        lib = _lib()
        fn = (lib.cat_group_norm_nhwc_bwd_bf16 if x.dtype == torch.bfloat16
              else lib.cat_group_norm_nhwc_bwd_f32)
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), _ptr(emb), dx.data_ptr(),
                    parts.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), _ptr(demb), n, c,
                    cpg, hw, int(silu), plan.wc, plan.k, plan.rows, plan.chunk,
                    torch.cuda.current_stream(x.device).cuda_stream)
        return _launched(rc, "group_norm_act backward", lay, None, dx, dweight, dbias, demb)
    vec = _vec(x, g, dx)
    plan = group_norm_plan(cpg, hw, x.element_size(), 2, bool(vec))
    parts = torch.empty((n * c * plan.pieces, 2), dtype=torch.float32, device=x.device)
    lib = _lib()
    fn = lib.cat_group_norm_bwd_bf16 if x.dtype == torch.bfloat16 else lib.cat_group_norm_bwd_f32
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), _ptr(emb), dx.data_ptr(), parts.data_ptr(), dweight.data_ptr(),
                dbias.data_ptr(), _ptr(demb), n, c, cpg, hw, int(silu), plan.k, plan.slice,
                plan.chunk, plan.pieces, vec, torch.cuda.current_stream(x.device).cuda_stream)
    return _launched(rc, "group_norm_act backward", lay, None, dx, dweight, dbias, demb)


class _GroupNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, emb, groups, eps, silu):
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        if x.device.type == "cpu":
            ctx.save_for_backward(x, weight, bias, emb)
            return group_norm_act_plain(x, groups, weight, bias, eps, emb, silu)
        y, mean, rstd = forward_cuda(x, groups, weight, bias, eps, emb, silu)
        ctx.save_for_backward(x, weight, bias, emb, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, emb, *stats = ctx.saved_tensors
        if stats:  # the gradient in x's layout (no copy where it already is)
            dx, dw, db, de = backward_cuda(x, _in_layout(g.to(x.dtype), layout(x)), ctx.groups,
                                           *stats, weight, bias, emb, ctx.silu)
        else:
            dx, dw, db, de = group_norm_act_backward_plain(x, g, ctx.groups, weight, bias,
                                                           ctx.eps, emb, ctx.silu)
        return dx, dw, db, de, None, None, None


def group_norm_act(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5, emb: Optional[torch.Tensor] = None,
                   silu: bool = False) -> torch.Tensor:
    """Trainable GroupNorm + affine (+ scale-shift from ``emb``) (+ SiLU):
    the kernels forward and backward on a CUDA tensor, keeping only x and
    the (N, G) statistics for the backward; the plain twin and its
    closed-form backward on a CPU tensor."""
    return _GroupNormAct.apply(x, weight, bias, emb, groups, eps, silu)
