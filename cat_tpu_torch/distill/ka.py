"""Kernel Alignment (KA), the CAT distillation loss (port of
``cat_tpu/distill/ka.py``).

    KA(X, Y) = <XXᵀ, YYᵀ> / (‖XXᵀ‖_F · ‖YYᵀ‖_F)

on batch-flattened activations.  The distiller maximises KA between student
and teacher activations at mapped layers (loss = -KA).

``gram`` launches the hand-written CUDA kernel (``cat_tpu_torch/csrc/gram.cu``)
for a CUDA tensor and the plain twin ``gram_plain`` for a CPU tensor.  The
backward needs only the saved Grams plus one more read of X and Y:
dKA/dX = 2 (G_Y - (s/n_x) G_X) X / sqrt(n_x n_y), a (B x B)(B x F) product
left to ``torch.matmul`` in float32, as the JAX package leaves it to XLA.

KA is invariant to the order of the feature axis, so flattening NCHW
activations gives the same value as the JAX package's NHWC flatten.
"""

from __future__ import annotations

import ctypes

import torch

from cat_tpu_torch.utils import cuda_build

_MAX_BATCH = 128
_CTAS_PER_SM = 4

# launches of the CUDA kernel since the last reset
launches = 0


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
        lib.cat_gram_bf16.restype = lib.cat_gram_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA Gram kernel on a (B, F) CUDA tensor; raises on
    anything it does not take."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"gram_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("gram_cuda needs a contiguous (B, F) tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gram_cuda takes bf16 or f32, got {x.dtype}")
    b, f = x.shape
    if not 1 <= b <= _MAX_BATCH or f < 1:
        raise ValueError(f"gram_cuda takes 1 <= B <= {_MAX_BATCH} and F >= 1, "
                         f"got {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    kt = 64 if bf16 else 32  # columns a CTA stages per step (gram.cu)
    # the bf16 kernel pads B to 16, 32, 64 or 128 rows (gram.cu)
    bp = next(r for r in (16, 32, 64, 128) if r >= b) if bf16 else b
    # ~4 CTAs per SM, but no chunk under 8·bp columns: a CTA's (bp, bp)
    # float32 partial then stays at most 1/4 of the bf16 bytes it reads
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk = max(-(-f // (_CTAS_PER_SM * sms)), 8 * bp)
    chunk = -(-chunk // kt) * kt
    nchunks = -(-f // chunk)
    partial = torch.empty((nchunks, bp, bp), dtype=torch.float32, device=x.device)
    g = torch.empty((b, b), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            vec = int(f % 8 == 0 and x.data_ptr() % 16 == 0)
            rc = lib.cat_gram_bf16(x.data_ptr(), b, f, chunk, nchunks, vec,
                                   partial.data_ptr(), g.data_ptr(), stream)
        else:
            rc = lib.cat_gram_f32(x.data_ptr(), b, f, chunk, nchunks,
                                  partial.data_ptr(), g.data_ptr(), stream)
    cuda_build.check(rc, "gram")
    launches += 1
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
        ctx.save_for_backward(x, y, gx, gy, s, nx, ny)
        return s * torch.rsqrt(nx * ny)

    @staticmethod
    def backward(ctx, g):
        x, y, gx, gy, s, nx, ny = ctx.saved_tensors
        inv = torch.rsqrt(nx * ny)
        # dKA/dG_X = (G_Y - (s/n_x) G_X) / sqrt(n_x n_y); dG_X/dX pulls back as 2 M X
        mx = (gy - (s / nx) * gx) * inv
        my = (gx - (s / ny) * gy) * inv
        dx = (2.0 * g) * (mx @ _flatten(x).float())
        dy = (2.0 * g) * (my @ _flatten(y).float())
        return dx.reshape(x.shape).to(x.dtype), dy.reshape(y.shape).to(y.dtype)


def ka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel alignment of two activation batches (any trailing shape)."""
    return _KA.apply(x, y)
