"""Int8 execution of a frozen network's convolutions (port of
``cat_tpu/ops/quant.py``).

The opt-in int8 teacher (``--teacher_compute_dtype int8|int8_static``) runs
the teacher's UNMODIFIED forward with every convolution rewritten to int8:

  * weights: a symmetric scale per output channel,
    qw = max(max|w| over all but the output dimension, 1e-8) / 127;
  * activations: one symmetric scale per conv call, qx = max(max|x|, 1e-8)
    / 127, taken on the device at each call (``int8``) or fixed by a
    calibration forward (``int8_static``);
  * values: clip(round(v / q), -127, 127) as int8, divided in float32 (not
    multiplied by a reciprocal) and rounded half to even, as ``jnp.round``;
  * an int32 accumulator, dequantised as acc · (qx · qw) in float32 and cast
    to the input's dtype; a bias is added after that cast, in that dtype, as
    flax adds it after its conv.

The JAX package reroutes the convolutions with a jaxpr interpreter; here a
``TorchFunctionMode`` (``_Int8Mode``) catches ``F.conv2d`` and
``F.conv_transpose2d`` inside the forward, so the split-height halo convs
of ``parallel/spatial.py`` are caught too.  A transposed conv is computed as
the JAX package's ``ConvTranspose2d`` (and XLA) computes it: a stride-1
conv over the input dilated by the stride, padded by d(k-1) - p (plus the
output padding at the end), with the kernel flipped and its axes swapped
(``lower_transposed``); its weight scale is therefore per output channel of
that kernel.

Under the ranks' collectives (``parallel/``) the activation scale of every
conv is that of the GLOBAL batch, as ``jnp.max`` of a sharded array is
under GSPMD: the local abs-max is all-reduced with MAX over the world (both
axes).  A halo conv's input holds its neighbours' rows or zero rows beside
its own, which never raises the global maximum.

The convolution itself (``int8_conv_acc`` / ``conv_dequant``):

  * CPU tensors: the plain version, the int8 values converted to float64
    and convolved by ``F.conv2d`` (exact: |acc| <= K·127² < 2⁵³);
  * CUDA, ``groups == 1``: an im2col of the int8 operand (a
    ``Tensor.unfold`` view copied once into a buffer of at most ~1 GiB,
    chunked over the batch) times the int8 kernel matrix through
    ``torch._int_mm`` (cuBLASLt, int8 x int8 -> int32), K and N zero-padded
    to multiples of 8 and M past 16, as it requires;
  * CUDA, ``groups > 1`` (depthwise convs): ``csrc/int8_conv.cu``, a direct
    conv with the dequantisation and the cast fused into its store.

Neither CUDA path falls back: a refused shape or a failed launch raises.
The JAX package hands this conv to XLA (``quant.py:85-86``); it is not a
TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from cat_tpu_torch.parallel import collectives
from cat_tpu_torch.utils import cuda_build

IM2COL_BYTES = 1 << 30  # the largest im2col buffer of one _int_mm call

# launches since the last reset: torch._int_mm calls, int8_conv.cu launches
launches = {"intmm": 0, "grouped": 0}

_OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
TEACHER_DTYPES = ("", "int8", "int8_static")  # --teacher_compute_dtype


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


# ---------------------------------------------------------------------------
# Quantisation
# ---------------------------------------------------------------------------


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """max(max|x|, 1e-8) / 127 in float32 (a 0-d tensor), over the global
    batch while the collectives run.  The abs-max of a bf16 tensor is a bf16
    value (the larger of -min and max), so it is taken before the upcast."""
    if x.numel():
        lo, hi = torch.aminmax(x.detach())  # one read, no |x| temporary
        m = torch.maximum(-lo, hi).float()
    else:
        m = x.new_zeros((), dtype=torch.float32)
    if collectives.active():
        m = collectives.all_reduce_max(m)
    return torch.clamp_min(m, 1e-8) / 127.0


def weight_scale(w: torch.Tensor) -> torch.Tensor:
    """Per output channel of an (out, in/groups, kh, kw) kernel."""
    return torch.clamp_min(w.detach().float().abs().amax(dim=(1, 2, 3)), 1e-8) / 127.0


def quantize(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """clip(round(v / q), -127, 127) as int8, v / q in float32."""
    return torch.div(v.float(), q).round_().clamp_(-127, 127).to(torch.int8)


def transposed_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """The (out, in/groups, kh, kw) kernel of the stride-1 conv that equals
    a transposed conv of torch weight (in, out/groups, kh, kw): axes swapped
    within each group, kh and kw flipped."""
    cin, cog, kh, kw = w.shape
    g = groups
    return (w.reshape(g, cin // g, cog, kh, kw).transpose(1, 2)
            .reshape(g * cog, cin // g, kh, kw).flip(2, 3))


def lower_transposed(xq: torch.Tensor, kernel: Tuple[int, int], stride, padding,
                     output_padding, dilation) -> torch.Tensor:
    """The input of the stride-1 conv that equals a transposed conv: x
    dilated by the stride and padded by d(k-1) - p above and left, d(k-1) -
    p + output_padding below and right (zeros)."""
    (sh, sw), (ph, pw), (oh, ow), (dh, dw) = map(_pair, (stride, padding, output_padding,
                                                         dilation))
    kh, kw = kernel
    top, left = dh * (kh - 1) - ph, dw * (kw - 1) - pw
    if top < 0 or left < 0:
        raise NotImplementedError("int8 transposed convs take padding <= dilation·(kernel - 1)")
    n, c, h, w = xq.shape
    hd, wd = (h - 1) * sh + 1, (w - 1) * sw + 1
    out = xq.new_zeros((n, c, top + hd + top + oh, left + wd + left + ow))
    out[:, :, top:top + hd:sh, left:left + wd:sw] = xq
    return out


# ---------------------------------------------------------------------------
# The int8 convolution
# ---------------------------------------------------------------------------


def int8_conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0, dilation=1,
                        groups: int = 1) -> torch.Tensor:
    """Plain version: the int32 accumulator of a zero-padded conv of int8
    operands, through a float64 conv (exact)."""
    return F.conv2d(xq.double(), wq.double(), None, _pair(stride), _pair(padding),
                    _pair(dilation), groups).to(torch.int32)


def _out_hw(h, w, kernel, stride, padding, dilation):
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    return (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1


def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    launches["intmm"] += 1
    return torch._int_mm(a, b)


def im2col_acc(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0, dilation=1,
               mm: Callable = _int_mm, max_bytes: int = IM2COL_BYTES) -> torch.Tensor:
    """The int32 accumulator of a ``groups == 1`` conv as im2col times the
    kernel matrix: ``mm(A, B)`` with A (M, K) row-major int8 and B (K, N) a
    transposed view of the (N, K) kernel matrix, K and N zero-padded to
    multiples of 8 and M to more than 16 rows (``torch._int_mm``'s rules);
    the batch is cut so that A stays within ``max_bytes``."""
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    n, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho, wo = _out_hw(h, w, (kh, kw), stride, padding, dilation)
    k = c * kh * kw
    kp, op = _ceil8(k), _ceil8(o)
    wm = wq.new_zeros((op, kp))
    wm[:o, :k] = wq.reshape(o, k)
    (ph, pw), (dh, dw) = padding, dilation
    if ph or pw:
        xp = xq.new_zeros((n, c, h + 2 * ph, w + 2 * pw))
        xp[:, :, ph:ph + h, pw:pw + w] = xq
    else:
        xp = xq
    acc = torch.empty((n, o, ho, wo), dtype=torch.int32, device=xq.device)
    per = max(1, min(n, max_bytes // max(1, ho * wo * kp)))
    for i in range(0, n, per):
        b = min(per, n - i)
        rows = b * ho * wo
        cols = (xp[i:i + b].unfold(2, dh * (kh - 1) + 1, stride[0])
                .unfold(3, dw * (kw - 1) + 1, stride[1])[..., ::dh, ::dw])  # (b, c, ho, wo, kh, kw)
        a = xq.new_empty((max(rows, 17), kp))
        if kp > k:
            a[:, k:] = 0
        if rows < a.shape[0]:
            a[rows:] = 0
        a[:rows, :k].view(b, ho, wo, c, kh, kw).copy_(cols.permute(0, 2, 3, 1, 4, 5))
        r = mm(a, wm.t())
        acc[i:i + b] = r[:rows, :o].reshape(b, ho, wo, o).permute(0, 3, 1, 2)
    return acc


def _lib():
    lib = cuda_build.load("int8_conv")
    if not getattr(lib, "_typed", False):
        lib.cat_int8_conv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [
            ctypes.c_void_p]
        lib.cat_int8_conv.restype = ctypes.c_int
        lib._typed = True
    return lib


def grouped_conv_cuda(xq: torch.Tensor, wq: torch.Tensor, scale: Optional[torch.Tensor],
                      out_dtype: torch.dtype, stride=1, padding=0, dilation=1,
                      groups: int = 1) -> torch.Tensor:
    """``csrc/int8_conv.cu``: the direct int8 conv of CUDA NCHW tensors; its
    int32 accumulator (``out_dtype`` int32) or, fused into the store,
    acc · scale[o] cast to ``out_dtype`` (float32 or bfloat16)."""
    if not (xq.is_cuda and wq.is_cuda) or xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError("grouped_conv_cuda takes int8 CUDA tensors")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"grouped_conv_cuda writes int32, float32 or bfloat16, not {out_dtype}")
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    xq, wq = xq.contiguous(), wq.contiguous()
    n, c, h, w = xq.shape
    o, cg, kh, kw = wq.shape
    if c != cg * groups or o % groups:
        raise ValueError(f"int8 conv: {c} input channels, kernel {tuple(wq.shape)}, "
                         f"{groups} groups")
    if out_dtype != torch.int32:
        if scale is None or scale.shape != (o,):
            raise ValueError("the fused dequantisation needs a float32 scale per output channel")
        scale = scale.float().contiguous()
    ho, wo = _out_hw(h, w, (kh, kw), stride, padding, dilation)
    y = torch.empty((n, o, ho, wo), dtype=out_dtype, device=xq.device)
    if y.numel():
        rc = _lib().cat_int8_conv(
            xq.data_ptr(), wq.data_ptr(), y.data_ptr(),
            0 if out_dtype == torch.int32 else scale.data_ptr(), _OUT_KINDS[out_dtype],
            n, c, h, w, o, ho, wo, kh, kw, *stride, *padding, *dilation, groups,
            torch.cuda.current_stream(xq.device).cuda_stream)
        cuda_build.check(rc, "int8_conv")
        launches["grouped"] += 1
    return y


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0, dilation=1,
                  groups: int = 1) -> torch.Tensor:
    """The int32 accumulator of a zero-padded conv of int8 operands: the
    plain version for CPU tensors; on CUDA ``torch._int_mm`` over an im2col
    (``groups == 1``) or ``csrc/int8_conv.cu``."""
    if xq.device.type == "cpu":
        return int8_conv_acc_plain(xq, wq, stride, padding, dilation, groups)
    if groups == 1:
        return im2col_acc(xq, wq, stride, padding, dilation)
    return grouped_conv_cuda(xq, wq, None, torch.int32, stride, padding, dilation, groups)


def conv_dequant(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
                 stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """acc · scale[o] in float32, cast to ``dtype``: fused into the store of
    ``csrc/int8_conv.cu`` for a CUDA grouped conv."""
    if xq.is_cuda and groups > 1:
        return grouped_conv_cuda(xq, wq, scale, dtype, stride, padding, dilation, groups)
    acc = int8_conv_acc(xq, wq, stride, padding, dilation, groups)
    return (acc.float() * scale.view(1, -1, 1, 1)).to(dtype)


def int8_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, stride=1,
              padding=0, dilation=1, groups: int = 1, x_scale: Optional[torch.Tensor] = None,
              transposed: bool = False, output_padding=0) -> torch.Tensor:
    """``F.conv2d(x, w, bias, ...)`` (or ``F.conv_transpose2d`` with
    ``transposed``) with int8 operands and an int32 accumulator, dequantised
    and cast to x's dtype, then the bias added in that dtype.
    ``x_scale``: a fixed activation scale (float32 0-d), else taken from
    x."""
    if transposed:
        w = transposed_weight(w, groups)
    qx = act_scale(x) if x_scale is None else x_scale
    qw = weight_scale(w)
    xq, wq = quantize(x, qx), quantize(w, qw.view(-1, 1, 1, 1))
    if transposed:
        xq = lower_transposed(xq, w.shape[2:], stride, padding, output_padding, dilation)
        stride, padding = 1, 0
    y = conv_dequant(xq, wq, qx * qw, x.dtype, stride, padding, dilation, groups)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


# ---------------------------------------------------------------------------
# Rerouting a forward's convolutions
# ---------------------------------------------------------------------------


def _conv_args(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return input, weight, bias, dict(stride=stride, padding=padding, dilation=dilation,
                                     groups=groups)


def _conv_transpose_args(input, weight, bias=None, stride=1, padding=0, output_padding=0,
                         groups=1, dilation=1):
    return input, weight, bias, dict(stride=stride, padding=padding, dilation=dilation,
                                     groups=groups, transposed=True,
                                     output_padding=output_padding)


_CONVS = {torch.conv2d: _conv_args, torch.conv_transpose2d: _conv_transpose_args}


class _Int8Mode(TorchFunctionMode):
    """Within the mode every ``F.conv2d`` / ``F.conv_transpose2d`` runs as
    ``int8_conv``: with the next of ``act_scales`` where given, recording
    its dynamic scale into ``collect`` where given.  ``count``: the convs
    seen, in call order."""

    def __init__(self, act_scales: Optional[Sequence[float]] = None,
                 collect: Optional[List[torch.Tensor]] = None):
        super().__init__()
        self.act_scales = act_scales
        self.collect = collect
        self.count = 0
        self._scales = None  # act_scales on the device, made at the first conv

    def __torch_function__(self, func, types, args=(), kwargs=None):
        parse = _CONVS.get(func)
        if parse is None:
            return func(*args, **(kwargs or {}))
        x, w, bias, kw = parse(*args, **(kwargs or {}))
        if isinstance(kw["padding"], str):
            raise NotImplementedError("int8 convs take numeric padding")
        scale = None
        if self.act_scales is not None:
            if self.count >= len(self.act_scales):
                raise ValueError(f"act_scales has only {len(self.act_scales)} entries but the "
                                 f"forward contains more convolutions (at conv #{self.count})")
            if self._scales is None:
                self._scales = torch.tensor(self.act_scales, dtype=torch.float32,
                                            device=x.device)
            scale = self._scales[self.count]
        elif self.collect is not None:
            scale = act_scale(x)
            self.collect.append(scale)
        self.count += 1
        return int8_conv(x, w, bias, x_scale=scale, **kw)


def int8_call(fn: Callable, *args, act_scales: Optional[Sequence[float]] = None):
    """``fn(*args)`` with every convolution executed in int8.  ``fn`` is an
    inference forward.  ``act_scales``: per-conv activation scales in call
    order (``int8_calibrate``); their number must equal the forward's
    convs.  Without them each conv takes its scale from its input."""
    with torch.no_grad(), _Int8Mode(act_scales) as mode:
        out = fn(*args)
    if act_scales is not None and mode.count != len(act_scales):
        raise ValueError(f"act_scales has {len(act_scales)} entries but the forward contains "
                         f"{mode.count} convolutions")
    return out


def int8_calibrate(fn: Callable, *args):
    """``fn(*args)`` in dynamic int8, and the per-conv activation scales it
    took, in call order, as host floats (one device-to-host copy):
    ``(outputs, act_scales)``."""
    collect: List[torch.Tensor] = []
    with torch.no_grad(), _Int8Mode(collect=collect):
        out = fn(*args)
    scales = tuple(torch.stack(collect).tolist()) if collect else ()
    return out, scales


def teacher_forward(fn: Callable, params, x: torch.Tensor, mode: str,
                    act_scales: Optional[Sequence[float]]):
    """``fn(params, x)``, the frozen teacher's forward, under no_grad, and
    the activation scales to keep: ``(outputs, act_scales)``.  For ``mode``
    '' the forward as it is; for 'int8' its convolutions in int8 at dynamic
    scales; for 'int8_static' at ``act_scales``, which this call calibrates
    on ``x`` when they are None (the calibrating forward's outputs are the
    static forward's at the scales it took).  Parameters and input are
    already in the compute dtype: the non-conv ops keep its traffic, and
    each conv's output comes back in it."""
    with torch.no_grad():
        if not mode:
            return fn(params, x), act_scales
        if mode == "int8_static":
            if act_scales is None:
                return int8_calibrate(fn, params, x)
            return int8_call(fn, params, x, act_scales=act_scales), act_scales
        return int8_call(fn, params, x), act_scales
