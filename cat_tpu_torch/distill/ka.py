"""Kernel Alignment (KA), the CAT distillation loss (port of
``cat_tpu/distill/ka.py``).

    KA(X, Y) = <XXᵀ, YYᵀ> / (‖XXᵀ‖_F · ‖YYᵀ‖_F)

on batch-flattened activations.  The distiller maximises KA between student
and teacher activations at mapped layers (loss = -KA).

``gram`` launches a hand-written CUDA kernel (``cat_tpu_torch/csrc/gram.cu``)
for a CUDA tensor and the plain twin ``gram_plain`` for a CPU tensor.
``_gram_path`` picks the kernel: TMA + wgmma for bf16 operands that meet
TMA's rules, mma.sync for other bf16 shapes; for float32, a TMA ring feeding
CUDA-core FMAs on the lower triangle, and the plain FMA kernel for operands
TMA cannot map.  The kernels take at most 128 rows; a larger batch is cut
into blocks of 64 rows and its Gram assembled from one launch per pair of
blocks (``gram_blocked``).
The backward needs only the saved Grams plus one more read of X or Y:
dKA/dX = 2 (G_Y - (s/n_x) G_X) X / sqrt(n_x n_y), a (B x B)(B x F) product
left to ``torch.matmul`` in float32, as the JAX package leaves it to XLA.
It computes only the gradients autograd asks for: in the distillation step
Y is the teacher's activation, whose gradient nobody reads.

KA is invariant to the order of the feature axis, so flattening NCHW
activations gives the same value as the JAX package's NHWC flatten.
"""

from __future__ import annotations

import ctypes

import torch

from cat_tpu_torch.utils import cuda_build

_MAX_BATCH = 128
_BLOCK_ROWS = 64  # rows of a block of gram_blocked: two blocks fill one launch
_CTAS_PER_SM = 4
_F32_TMA_CONSUMERS = 480  # consumer threads in a CTA of the f32 TMA kernel (gram.cu)

# launches of the CUDA kernels since the last reset: in all, and by path
launches = 0
path_launches = {"tma": 0, "mma": 0, "f32tma": 0, "f32": 0}


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 X·Xᵀ of a 2-D batch-major operand (products
    of two bf16 values are exact in float32)."""
    xf = x.float()
    return xf @ xf.T


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
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.cat_gram_f32_tma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
    "f32" (synchronous staging + FMAs) for other float32 operands; and
    "blocked" (``gram_blocked`` over those kernels) for b > 128.  Raises on
    what no kernel takes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gram_cuda takes bf16 or f32, got {dtype}")
    if b < 1 or f < 1:
        raise ValueError(f"gram_cuda takes B >= 1 and F >= 1, got {(b, f)}")
    if b > _MAX_BATCH:
        return "blocked"
    if dtype == torch.float32:
        return "f32tma" if f % 4 == 0 and aligned else "f32"
    return "tma" if f % 8 == 0 and aligned else "mma"


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
    path = _gram_path(*x.shape, x.dtype, x.data_ptr() % 16 == 0)
    if path == "blocked":
        return gram_blocked(x, gram_cuda)
    return _gram_launch(x, path)


def gram_blocked(x: torch.Tensor, gram_fn) -> torch.Tensor:
    """X·Xᵀ of a (B, F) operand with B > 128 from ``gram_fn`` on operands of
    at most 128 rows: the rows are cut into n = ⌈B/64⌉ blocks, and for each
    pair i < j, ``gram_fn([X_i; X_j])`` gives G_ij (its off-diagonal block,
    also written transposed as G_ji, so G == Gᵀ exactly) and, for a block
    not yet placed, G_ii (the first pair that holds block i, so calls are
    reproducible; its lower triangle mirrored).  n(n-1)/2 calls, each on a
    fresh contiguous copy of the two blocks."""
    b = x.shape[0]
    blocks = x.split(_BLOCK_ROWS)
    starts = [i * _BLOCK_ROWS for i in range(len(blocks))]
    g = torch.empty((b, b), dtype=torch.float32, device=x.device)
    placed = set()
    for i in range(len(blocks)):
        for j in range(i + 1, len(blocks)):
            bi, bj = blocks[i].shape[0], blocks[j].shape[0]
            si, sj = starts[i], starts[j]
            gij = gram_fn(torch.cat([blocks[i], blocks[j]]))
            off = gij[:bi, bi:]
            g[si:si + bi, sj:sj + bj] = off
            g[sj:sj + bj, si:si + bi] = off.T
            for k, s, n, d in ((i, si, bi, gij[:bi, :bi]), (j, sj, bj, gij[bi:, bi:])):
                if k not in placed:
                    g[s:s + n, s:s + n] = d.tril() + d.tril(-1).T
                    placed.add(k)
    return g


def _gram_launch(x: torch.Tensor, path: str) -> torch.Tensor:
    """Launch kernel ``path`` on an operand ``gram_cuda`` has checked.  The
    comparisons of the two designs of each dtype (chip_smoke.py, the card
    tests) also call it with "mma", which takes any bf16 operand, and with
    "f32", which takes any float32 operand."""
    global launches
    b, f = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # the rows each kernel pads B to (gram.cu)
    if path == "f32tma":
        bp, groups = _f32_tma_plan(b)
    elif path == "f32":
        bp = b
    else:  # the bf16 kernels' instances
        bp = next(r for r in (16, 32, 64, 128) if r >= b)
    g = torch.empty((b, b), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if path in ("tma", "f32tma"):
            # one persistent CTA per SM, one partial each
            partial = torch.empty((sms, bp, bp), dtype=torch.float32, device=x.device)
            if path == "tma":
                rc = lib.cat_gram_bf16_tma(x.data_ptr(), b, f, sms, partial.data_ptr(),
                                           g.data_ptr(), stream)
            else:
                rc = lib.cat_gram_f32_tma(x.data_ptr(), b, f, bp, groups, sms,
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
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return gram_plain(x)
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
    """Kernel alignment of two activation batches (any trailing shape)."""
    return _KA.apply(x, y)
