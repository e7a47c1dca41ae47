"""Kernel Alignment (KA), the CAT distillation loss (port of
``cat_tpu/distill/ka.py``).

    KA(X, Y) = <XXᵀ, YYᵀ> / (‖XXᵀ‖_F · ‖YYᵀ‖_F)

on batch-flattened activations.  The distiller maximises KA between student
and teacher activations at mapped layers (loss = -KA).

``gram`` launches a hand-written CUDA kernel (``cat_tpu_torch/csrc/gram.cu``)
for a CUDA tensor and a plain twin for a CPU tensor (``gram_plain``, and
``gram_pairs_plain`` past 128 rows).  ``_gram_path`` picks the kernel: TMA +
wgmma for bf16 operands that meet TMA's rules, mma.sync for other bf16
shapes; for float32, a TMA ring feeding CUDA-core FMAs on the lower
triangle, and the plain FMA kernel for operands TMA cannot map.  Past 128
rows, the pair kernels of either dtype compute every pair of 128-row blocks
in one launch over the plan of ``_pair_plan``, reading X in place (or a
zero-padded copy of an operand TMA cannot map).
The backward needs only the saved Grams plus one more read of X or Y:
dKA/dX = 2 (G_Y - (s/n_x) G_X) X / sqrt(n_x n_y), a (B x B)(B x F) product
left to ``torch.matmul`` in float32, as the JAX package leaves it to XLA.
It computes only the gradients autograd asks for: in the distillation step
Y is the teacher's activation, whose gradient nobody reads.

KA is invariant to the order of the feature axis, so flattening NCHW
activations gives the same value as the JAX package's NHWC flatten.

Over several ranks KA is that of the GLOBAL batch, as in the JAX package,
whose distillers compute the single-device function of a batch-sharded
input (``tests/test_sharding.py:61-95`` holds the KA step on an 8-way mesh,
one row a shard, to the single-device step; a KA per shard would be the
constant 1 there).  ``ka`` gathers both taps' rows from every rank
(``parallel/collectives.py::all_gather_rows``, the student's with its
gradient) and runs the Gram kernels on the global rows.
"""

from __future__ import annotations

import ctypes

import torch

from cat_tpu_torch.parallel import collectives
from cat_tpu_torch.utils import cuda_build

_MAX_BATCH = 128
_PAIR_ROWS = 128  # rows of a block of the pair kernels (gram.cu)
_PAIR_PATHS = ("tma_pairs", "f32tma_pairs")
_CTAS_PER_SM = 4
_F32_TMA_CONSUMERS = 480  # consumer threads in a CTA of the f32 TMA kernel (gram.cu)

# launches of the CUDA kernels since the last reset: in all, and by path
launches = 0
path_launches = {"tma": 0, "mma": 0, "f32tma": 0, "f32": 0, "tma_pairs": 0, "f32tma_pairs": 0}
_plans = {}  # (blocks, SMs, device) -> the pair plan as an int32 tensor on the device


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 X·Xᵀ of a 2-D batch-major operand (products
    of two bf16 values are exact in float32)."""
    xf = x.float()
    return xf @ xf.T


def gram_pairs_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the pair kernels: the float32 X_i·X_jᵀ of every pair
    i >= j of 128-row blocks, written at (i, j) and transposed at (j, i), a
    diagonal block's lower triangle mirrored, so G == Gᵀ exactly."""
    xf = x.float()
    g = xf.new_empty((x.shape[0], x.shape[0]))
    blocks = xf.split(_PAIR_ROWS)
    for i, xi in enumerate(blocks):
        si = i * _PAIR_ROWS
        for j in range(i + 1):
            sj, xj = j * _PAIR_ROWS, blocks[j]
            gij = xi @ xj.T
            if i == j:
                gij = gij.tril() + gij.tril(-1).T
            g[si:si + xi.shape[0], sj:sj + xj.shape[0]] = gij
            g[sj:sj + xj.shape[0], si:si + xi.shape[0]] = gij.T
    return g


def _pair_plan(b: int, sms: int):
    """The work units of the pair kernels for a batch of b on a card of
    ``sms`` SMs, one CTA each: (units, starts).  units[u] = (bi, bj, first,
    stride): pair (bi, bj) of 128-row blocks over the 64-column tiles first,
    first + stride, ... of F.  Pairs come in order p = i(i+1)/2 + j, and
    pair p's units are units[starts[p]:starts[p + 1]].  With n blocks, each
    diagonal pair gets g = max(1, sms // n²) units and each off-diagonal one
    2g (it loads two boxes a tile, so twice the stride balances the bytes),
    n²·g CTAs in all; a pair's units cover every tile once."""
    n = -(-b // _PAIR_ROWS)
    g = max(1, sms // (n * n))
    units, starts = [], [0]
    for i in range(n):
        for j in range(i + 1):
            stride = g if i == j else 2 * g
            units += [(i, j, first, stride) for first in range(stride)]
            starts.append(len(units))
    return units, starts


def _pair_plan_tensor(b: int, sms: int, device: torch.device):
    """``_pair_plan`` as the kernels read it (int32 on the device: the units'
    rows, then the starts), made once per block count and card; and the
    number of units."""
    n = -(-b // _PAIR_ROWS)
    key = (n, sms, str(device))
    if key not in _plans:
        units, starts = _pair_plan(b, sms)
        flat = [v for u in units for v in u] + starts
        _plans[key] = (torch.tensor(flat, dtype=torch.int32, device=device), len(units))
    return _plans[key]


def _lib():
    lib = cuda_build.load("gram")
    if not getattr(lib, "_typed", False):
        lib.cat_gram_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.cat_gram_f32.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
        lib.cat_gram_bf16_tma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p]
        lib.cat_gram_f32_tma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.cat_gram_bf16.restype = lib.cat_gram_f32.restype = ctypes.c_int
        lib.cat_gram_bf16_tma.restype = lib.cat_gram_f32_tma.restype = ctypes.c_int
        lib._typed = True
    return lib


def _gram_path(b: int, f: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel that takes a (b, f) operand of ``dtype`` (``aligned``: its
    address is a multiple of 16 bytes): "tma" (TMA ring + wgmma) for bf16
    when TMA can map it (a row stride of f·2 bytes must be a multiple of 16,
    so f % 8 == 0, and the base address 16-byte aligned), "mma" (cp.async +
    mma.sync) for other bf16 operands; "f32tma" (TMA ring + FMAs on the
    lower triangle) for float32 when TMA can map it (f % 4 == 0, aligned),
    "f32" (synchronous staging + FMAs) for other float32 operands; and for
    b > 128 the pair kernels, "tma_pairs" (bf16) and "f32tma_pairs"
    (float32), on X or on the copy ``_pair_copy_width`` asks for.  Raises on
    what no kernel takes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gram_cuda takes bf16 or f32, got {dtype}")
    if b < 1 or f < 1:
        raise ValueError(f"gram_cuda takes B >= 1 and F >= 1, got {(b, f)}")
    if b > _MAX_BATCH:
        return "f32tma_pairs" if dtype == torch.float32 else "tma_pairs"
    if dtype == torch.float32:
        return "f32tma" if f % 4 == 0 and aligned else "f32"
    return "tma" if f % 8 == 0 and aligned else "mma"


def _pair_copy_width(f: int, dtype: torch.dtype, aligned: bool):
    """None when the pair kernels read a (b, f) operand in place (TMA maps
    it: f·itemsize a multiple of 16 bytes and an aligned base), else the
    width of the zero-padded copy they read instead, f rounded up to a
    multiple of 8 (zero columns add nothing)."""
    if aligned and f % (8 if dtype == torch.bfloat16 else 4) == 0:
        return None
    return -(-f // 8) * 8


def _f32_tma_plan(b: int):
    """(bp, groups) of the f32 TMA kernel for a batch of b: rows padded to
    bp, a multiple of 8, and each of the triangle's (bp/8)(bp/8 + 1)/2 blocks
    of 8 x 8 entries shared by ``groups`` threads, the most of 32, 16, ...,
    1 that keeps the consumers within 15 warps."""
    bp = -(-b // 8) * 8
    blocks = (bp // 8) * (bp // 8 + 1) // 2
    return bp, next(g for g in (32, 16, 8, 4, 2, 1) if blocks * g <= _F32_TMA_CONSUMERS)


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA Gram kernel that ``_gram_path`` picks on a (B, F)
    CUDA tensor; raises on anything no kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"gram_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("gram_cuda needs a contiguous (B, F) tensor")
    b, f = x.shape
    aligned = x.data_ptr() % 16 == 0
    path = _gram_path(b, f, x.dtype, aligned)
    if path in _PAIR_PATHS:
        width = _pair_copy_width(f, x.dtype, aligned)
        if width is not None:
            xp = x.new_zeros((b, width))  # the allocator's blocks are 512-byte aligned
            xp[:, :f] = x
            x = xp
    return _gram_launch(x, path)


def _gram_launch(x: torch.Tensor, path: str) -> torch.Tensor:
    """Launch kernel ``path`` on an operand ``gram_cuda`` has checked.  The
    comparisons of the two designs of each dtype (chip_smoke.py, the card
    tests) also call it with "mma", which takes any bf16 operand, and with
    "f32", which takes any float32 operand."""
    global launches
    b, f = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # the rows each kernel pads B to (gram.cu); a pair kernel's blocks are
    # the B = 128 kernel's
    rows = min(b, _PAIR_ROWS)
    if path in ("f32tma", "f32tma_pairs"):
        bp, groups = _f32_tma_plan(rows)
    elif path == "f32":
        bp = b
    else:  # the bf16 kernels' instances
        bp = next(r for r in (16, 32, 64, 128) if r >= rows)
    g = torch.empty((b, b), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if path in ("tma", "f32tma", *_PAIR_PATHS):
            # one persistent CTA per SM, or per unit of the pair plan; one partial each
            if path in _PAIR_PATHS:
                plan, ctas = _pair_plan_tensor(b, sms, x.device)
                plan_ptr = plan.data_ptr()
            else:
                plan_ptr, ctas = None, sms
            partial = torch.empty((ctas, bp, bp), dtype=torch.float32, device=x.device)
            if path in ("tma", "tma_pairs"):
                rc = lib.cat_gram_bf16_tma(x.data_ptr(), b, f, plan_ptr, ctas, partial.data_ptr(),
                                           g.data_ptr(), stream)
            else:
                rc = lib.cat_gram_f32_tma(x.data_ptr(), b, f, bp, groups, plan_ptr, ctas,
                                          partial.data_ptr(), g.data_ptr(), stream)
        else:
            kt = 64 if path == "mma" else 32  # columns a CTA stages per step (gram.cu)
            # ~4 CTAs per SM, but no chunk under 8·bp columns: a CTA's (bp, bp)
            # float32 partial then stays at most 1/4 of the bf16 bytes it reads
            chunk = max(-(-f // (_CTAS_PER_SM * sms)), 8 * bp)
            chunk = -(-chunk // kt) * kt
            nchunks = -(-f // chunk)
            partial = torch.empty((nchunks, bp, bp), dtype=torch.float32, device=x.device)
            if path == "mma":
                vec = int(f % 8 == 0 and x.data_ptr() % 16 == 0)
                rc = lib.cat_gram_bf16(x.data_ptr(), b, f, chunk, nchunks, vec,
                                       partial.data_ptr(), g.data_ptr(), stream)
            else:
                rc = lib.cat_gram_f32(x.data_ptr(), b, f, chunk, nchunks,
                                      partial.data_ptr(), g.data_ptr(), stream)
    cuda_build.check(rc, "gram")
    launches += 1
    path_launches[path] += 1
    return g


def gram(x: torch.Tensor) -> torch.Tensor:
    """X·Xᵀ in float32 for a 2-D batch-major operand: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor (past 128 rows, the
    pair kernels' own)."""
    if x.device.type == "cpu":
        return gram_pairs_plain(x) if x.shape[0] > _MAX_BATCH else gram_plain(x)
    return gram_cuda(x)


def gram_pair(x: torch.Tensor, y: torch.Tensor):
    """(XXᵀ, YYᵀ) for 2-D batch-major operands: one kernel launch each."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError("gram_pair takes two 2-D operands with one batch size")
    return gram(x), gram(y)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


class _KA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        xf, yf = _flatten(x), _flatten(y)
        if xf.shape[0] != yf.shape[0]:
            raise ValueError(
                f"X and Y must share the batch dimension, got {xf.shape[0]} vs {yf.shape[0]}"
            )
        gx, gy = gram_pair(xf.contiguous(), yf.contiguous())
        s = (gx * gy).sum()
        nx = (gx * gx).sum()
        ny = (gy * gy).sum()
        # an operand is kept only if its own gradient is wanted
        need_x, need_y = ctx.needs_input_grad
        ctx.save_for_backward(x if need_x else None, y if need_y else None, gx, gy, s, nx, ny)
        return s * torch.rsqrt(nx * ny)

    @staticmethod
    def backward(ctx, g):
        x, y, gx, gy, s, nx, ny = ctx.saved_tensors
        inv = torch.rsqrt(nx * ny)
        # dKA/dG_X = (G_Y - (s/n_x) G_X) / sqrt(n_x n_y); dG_X/dX pulls back as 2 M X
        dx = dy = None
        if ctx.needs_input_grad[0]:
            mx = (gy - (s / nx) * gx) * inv
            dx = ((2.0 * g) * (mx @ _flatten(x).float())).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            my = (gx - (s / ny) * gy) * inv
            dy = ((2.0 * g) * (my @ _flatten(y).float())).reshape(y.shape).to(y.dtype)
        return dx, dy


def ka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel alignment of two activation batches (any trailing shape); of
    the global batch when the ranks' collectives run."""
    return _KA.apply(collectives.all_gather_rows(x), collectives.all_gather_rows(y))
