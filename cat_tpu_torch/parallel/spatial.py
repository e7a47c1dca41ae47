"""Spatial parallelism: image height split over the ranks of a spatial axis
(port of ``--n_spatial``, the JAX package's second mesh axis,
``cat_tpu/parallel/mesh.py:38-69``).

GSPMD partitions the JAX package's convolutions itself.  Here the halo code
is by hand, and every layer that looks across rows calls it:

  * **Row ownership**, GSPMD's layout for an uneven dimension: of a global
    height h, shard s of S owns rows ``[s·⌈h/S⌉, min(h, (s+1)·⌈h/S⌉))``
    (``rows``), at every activation height.  A layer computes the output
    rows its rank owns, from the input rows they need, fetched from
    whichever ranks own them.  Shards can be uneven (the NLayer D's
    stride-1 layers take 32 rows to 31 and 30), so nothing assumes equal
    shares.
  * **Halo rows** (``halo``): the rows a valid (k, stride) convolution of
    a height-padded input needs for this rank's output rows: the rank's
    own rows, rows of other ranks (one all-gather of fixed-size edge strips
    over the axis, ``_Exchange``), and the global padding (zero, reflect or
    replicate) at the global top and bottom only.  Its backward sends each
    halo row's gradient back to its owner (``_ExchangeT``, an all-to-all),
    which adds it to its own rows' gradient; each of the two Functions is
    the other's backward, so the exchange is twice differentiable (the
    WGAN-GP penalty differentiates D's input gradient).
    ``conv2d`` and ``conv_transpose2d`` run a convolution with built-in
    padding (the generator's down- and upsampling, every NLayer conv) this
    way; ``ops/nn.py::spatial_pad`` pads the height of an explicitly padded
    one (reflect pads, inception blocks); widths keep their padding.
  * **The SPADE family** (item 16c): nearest resizes of a split height
    (``nearest_resize``, the generator's 2x upsampling: each output row
    reads row ⌊i·h_in/h_out⌋ of the window the rank fetches), pools over
    halo rows (``max_pool2d``, VGG's 2x2; ``avg_pool2d``, the multiscale
    D's 3x3/2 with the padding out of the divisor, which comes from the
    same pool over the real rows of the window), and a functional halo
    conv (``conv2d_fn``: the packed SPADE branches, the spectral convs,
    VGG's convs; ``conv2d`` calls it).  The label maps are not split: every
    rank holds them whole (``whole=True``), so a conv over the semantics
    cuts its window from them with no exchange, and the D input's
    semantics are the rank's rows (``collectives.local_height``).  A rank
    may own no rows of a small height (a 1-row latent over two ranks): it
    computes an empty output and still runs every collective.
  * **Sums over the axis**: instance-norm plane sums and the gradient
    penalty's per-sample sums are all-reduced over the spatial axis, batch
    norm's over the world (``ops/nn.py``), KA's Gram partial sums over the
    spatial axis (``distill/ka.py``); ``mean`` is a mean over the global
    tensor, its count summed over the axis.

Every rank of the axis computes the same sequence of collectives, in the
forward and in the backward.  Without a split (one spatial rank, or the
collectives off in ``collectives.local()``) every function is the plain
op on the whole height.  Heights are host integers; a network's forward
learns its input's global height once (``global_height``, a sum over a
gloo group on the host) and derives the rest from the layers' arithmetic.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cat_tpu_torch.parallel import collectives


def active() -> bool:
    """Whether image height is split over more than one rank."""
    return collectives.axis("spatial")[2] > 1


def rows(h: int, index: int, n: int) -> Tuple[int, int]:
    """[start, stop) of the rows of a global height ``h`` that shard
    ``index`` of ``n`` owns (GSPMD's layout: ⌈h/n⌉ rows a shard, the last
    ones short or empty)."""
    c = -(-h // n)
    return min(h, index * c), min(h, (index + 1) * c)


def count_sum(n: int) -> int:
    """A host integer summed over the spatial axis (on its gloo group: no
    device round trip)."""
    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t, group=collectives.meta_group())
    return int(t)


def global_height(x: torch.Tensor) -> Optional[int]:
    """The global height of an activation whose dim 2 this rank holds its
    rows of; None when the height is not split."""
    if not active():
        return None
    return count_sum(x.shape[2])


def full_height(x: torch.Tensor, height: Optional[int] = None) -> int:
    """``height`` where the caller knows it, else x's global height (its own
    when the height is not split)."""
    if height is not None:
        return height
    h = global_height(x)
    return x.shape[2] if h is None else h


def out_height(h: Optional[int], k: int, stride: int = 1, pad: int = 0) -> Optional[int]:
    """The output height of a (k, stride) window over height ``h`` padded
    by ``pad`` rows above and below."""
    if h is None:
        return None
    return (h + 2 * pad - k) // stride + 1


def conv_height(h: Optional[int], conv) -> Optional[int]:
    """The output height of ``conv`` (an ``nn.Conv2d``) over height ``h``."""
    return out_height(h, conv.dilation[0] * (conv.kernel_size[0] - 1) + 1, conv.stride[0],
                      conv.padding[0])


def conv_transpose_height(h: Optional[int], conv) -> Optional[int]:
    """The output height of ``conv`` (an ``nn.ConvTranspose2d``) over ``h``."""
    if h is None:
        return None
    return ((h - 1) * conv.stride[0] - 2 * conv.padding[0] + conv.kernel_size[0]
            + conv.output_padding[0])


def mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()``; over a split height, this rank's share of the mean of
    the global tensor, ``Σ_local x · S / N``, N the count summed over the
    spatial axis: shards may be uneven, and the ranks' shares sum to S
    times the mean (each rank's objective is then S times its data index's
    share, as every other loss of a step: ``train/common.py::average_grads``
    divides the world out, ``global_metrics`` reports the mean)."""
    if not active():
        return x.mean()
    return x.sum() * (collectives.axis("spatial")[2] / count_sum(x.numel()))


# ---------------------------------------------------------------------------
# the halo exchange
# ---------------------------------------------------------------------------


class _Exchange(torch.autograd.Function):
    """x's rows -> the rank's window of rows (``exchange``); its backward is
    ``_ExchangeT``, the transpose, and the transpose's is this again, so
    the exchange is differentiable any number of times.  Both run their
    collective on every rank of the axis whenever any rank does: a rank's
    window is always the input of its next layer, so every rank reaches
    the backward, whether or not its own window holds others' rows."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.rows = plan, x.shape[2]
        return _gather_window(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _ExchangeT.apply(g, ctx.plan, ctx.rows), None


class _ExchangeT(torch.autograd.Function):
    """A window's gradient -> the gradient of the rank's own rows: its own
    rows' parts added in place, the other ranks' rows sent back to their
    owners (an all-to-all over the axis) and added there."""

    @staticmethod
    def forward(ctx, g, plan, n_rows):
        ctx.plan = plan
        return _scatter_window(g, plan, n_rows)

    @staticmethod
    def backward(ctx, h):
        return _Exchange.apply(h, ctx.plan), None, None


def _resolve(i: int, h: int, mode: str) -> Optional[int]:
    """The source row of padded row ``i`` of a height ``h``; None for a
    zero row."""
    if 0 <= i < h:
        return i
    if mode == "zero":
        return None
    if mode == "replicate":
        return min(max(i, 0), h - 1)
    if mode == "reflect":
        j = -i if i < 0 else 2 * (h - 1) - i
        if not 0 <= j < h:
            raise ValueError(f"reflect padding of {max(-i, i - h + 1)} rows needs a height "
                             f"above that, got {h}")
        return j
    raise NotImplementedError(f"padding [{mode}] is not implemented")


@functools.lru_cache(maxsize=None)
def _plan(h: int, windows: Tuple[Tuple[int, int], ...], mode: str, me: int):
    """The exchange that gives shard ``me`` the rows ``windows[me]`` of a
    height ``h`` split over ``len(windows)`` shards (padded rows resolved by
    ``mode``): (L, rows ``me`` sends, zero row needed, segments).  Every
    shard sends L rows (the most any shard must send, zero-filled), the rows
    of its own that another shard's window needs; ``me``'s window is a list
    of segments (``"x"``: its own rows, ``"pool"``: rows of the gathered
    strips, the zero row last), each a tuple of indices."""
    n = len(windows)
    owned = [rows(h, q, n) for q in range(n)]

    def owner(i):
        return next(q for q, (a, b) in enumerate(owned) if a <= i < b)

    need = [[_resolve(i, h, mode) for i in range(a, b)] for a, b in windows]
    send = [sorted({i for q in range(n) if q != r for i in need[q]
                    if i is not None and owner(i) == r}) for r in range(n)]
    width = max(len(s) for s in send)
    start, stop = owned[me]
    segments, zero = [], False
    for i in need[me]:
        if i is not None and start <= i < stop:
            kind, j = "x", i - start
        elif i is None:
            kind, j, zero = "pool", n * width, True
        else:
            r = owner(i)
            kind, j = "pool", r * width + send[r].index(i)
        if segments and segments[-1][0] == kind:
            segments[-1][1].append(j)
        else:
            segments.append((kind, [j]))
    return (width, tuple(i - start for i in send[me]), zero,
            tuple((k, tuple(v)) for k, v in segments))


@functools.lru_cache(maxsize=None)
def _index(idx: Tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor(idx, dtype=torch.long, device=device)


def _take(src: torch.Tensor, idx: Tuple[int, ...]) -> torch.Tensor:
    if idx == tuple(range(idx[0], idx[0] + len(idx))):
        return src.narrow(2, idx[0], len(idx))
    return src.index_select(2, _index(idx, str(src.device)))


def _gather_window(x: torch.Tensor, plan) -> torch.Tensor:
    group, n, width, sends, zero, segments = plan
    pool = []
    if width:  # every rank's strip of the rows others need, L rows each
        strip = x.new_zeros((*x.shape[:2], width, x.shape[3]))
        if sends:
            strip[:, :, :len(sends)] = _take(x, sends)
        parts = [torch.empty_like(strip) for _ in range(n)]
        dist.all_gather(parts, strip, group=group)
        pool += parts
    if zero:
        pool.append(x.new_zeros((*x.shape[:2], 1, x.shape[3])))
    pool = torch.cat(pool, 2) if len(pool) > 1 else (pool[0] if pool else None)
    parts = [_take(x if kind == "x" else pool, idx) for kind, idx in segments]
    if not parts:  # an empty window
        return x.new_zeros((*x.shape[:2], 0, x.shape[3]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, 2)


def _scatter_window(g: torch.Tensor, plan, n_rows: int) -> torch.Tensor:
    group, n, width, sends, zero, segments = plan
    b, c, _, w = g.shape
    out = g.new_zeros((b, c, n_rows, w))
    pool = g.new_zeros((b, c, n * width + int(zero), w))
    off = 0
    for kind, idx in segments:
        (out if kind == "x" else pool).index_add_(2, _index(idx, str(g.device)),
                                                  g.narrow(2, off, len(idx)))
        off += len(idx)
    if width:  # chunk q of the strips' gradient goes back to rank q, which sums them
        send = pool[:, :, :n * width].reshape(b, c, n, width, w).permute(2, 0, 1, 3, 4)
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        if sends:
            out.index_add_(2, _index(sends, str(g.device)), recv.sum(0)[:, :, :len(sends)])
    return out


def exchange(x: torch.Tensor, h: int, windows: Sequence[Tuple[int, int]],
             mode: str = "zero") -> torch.Tensor:
    """Global rows ``windows[s]`` (``[a, b)``, possibly past either edge) of
    the height-``h`` tensor whose rows this rank holds, for this rank s;
    rows outside [0, h) are resolved by ``mode`` (zero, reflect,
    replicate).  A collective over the spatial axis: every rank calls it
    with the same ``h`` and ``windows``."""
    group, me, n = collectives.axis("spatial")
    start, stop = rows(h, me, n)
    if x.shape[2] != stop - start:
        raise ValueError(f"rank {me} of {n} holds {x.shape[2]} rows of a height {h}; its "
                         f"share is {stop - start}")
    return _Exchange.apply(x, (group, n, *_plan(h, tuple(windows), mode, me)))


def _window(o0: int, o1: int, k: int, stride: int, top: int) -> Tuple[int, int]:
    """The input rows ``[a, b)`` (past the edges where padded by ``top``
    rows) that a (k, stride) window turns into output rows ``[o0, o1)``; an
    empty window for no output rows."""
    a = o0 * stride - top
    return (a, (o1 - 1) * stride + k - top) if o1 > o0 else (a, a)


def halo(x: torch.Tensor, h: int, k: int, stride: int, top: int, bottom: int,
         mode: str = "zero") -> torch.Tensor:
    """The rows that a valid convolution of kernel height ``k`` and
    ``stride`` over x (global height ``h``) padded by ``top`` and ``bottom``
    rows (``mode``) turns into this rank's rows of its output."""
    _, _, n = collectives.axis("spatial")
    h_out = (h + top + bottom - k) // stride + 1
    return exchange(x, h, [_window(*rows(h_out, q, n), k, stride, top) for q in range(n)], mode)


def _whole_window(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows ``[a, b)`` of a tensor every rank holds at full height, zero
    past its edges (no exchange)."""
    h = x.shape[2]
    top = max(0, min(b, 0) - a)
    bottom = max(0, b - max(a, h))
    a0 = min(max(a, 0), h)
    slab = x.narrow(2, a0, max(0, b - a - top - bottom))
    return F.pad(slab, (0, 0, top, bottom)) if top or bottom else slab


def window(x: torch.Tensor, k: int, stride: int, top: int, bottom: int) -> torch.Tensor:
    """``halo``'s rows for a tensor every rank holds at full height (the
    semantics made from the whole label maps), zero-padded: cut from it."""
    _, me, n = collectives.axis("spatial")
    h_out = (x.shape[2] + top + bottom - k) // stride + 1
    return _whole_window(x, *_window(*rows(h_out, me, n), k, stride, top))


def _valid_rows(fn, slab: torch.Tensor, k: int) -> torch.Tensor:
    """``fn`` (a valid op of window height ``k``) over ``slab``.  A rank that
    owns no output rows has an empty slab: it runs ``fn`` on k zero rows and
    keeps none, so that its parameters and its window stay in the graph
    and its backward reaches the exchange's collective."""
    if slab.shape[2]:
        return fn(slab)
    return fn(F.pad(slab, (0, 0, 0, k))).narrow(2, 0, 0)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d_fn(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride=1, padding=0, groups: int = 1, h: Optional[int] = None,
              whole: bool = False) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding, 1, groups)`` with zero
    padding.  Over a split height this rank's output rows: the height
    padding comes from the neighbours (``halo``) and is zero only at the
    global top and bottom, the width keeps its own; ``whole``: x is held
    at full height by every rank (``window``: no exchange).  ``h``: x's
    global height where the caller knows it."""
    stride, padding = _pair(stride), _pair(padding)
    if not active():
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)
    k = weight.shape[2]
    if whole:
        slab = window(x, k, stride[0], padding[0], padding[0])
    else:
        slab = halo(x, full_height(x, h), k, stride[0], padding[0], padding[0], "zero")
    return _valid_rows(lambda t: F.conv2d(t, weight, bias, stride, (0, padding[1]), 1, groups),
                       slab, k)


def conv2d(conv, x: torch.Tensor, h: Optional[int] = None, whole: bool = False) -> torch.Tensor:
    """``conv(x)`` (an ``nn.Conv2d`` with zero padding) through ``conv2d_fn``."""
    if conv.dilation[0] != 1 or conv.padding_mode != "zeros":
        raise NotImplementedError("split-height convolutions take dilation 1, zero padding")
    return conv2d_fn(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.groups, h, whole)


def conv_transpose2d(conv, x: torch.Tensor, h: Optional[int] = None) -> torch.Tensor:
    """``conv(x)`` (an ``nn.ConvTranspose2d``) over a split height: output
    row o takes input rows (o + p - kh) / s; this rank's input rows and the
    rows below them it needs (zero past the global bottom) are transposed
    without height padding, and its own output rows cut out."""
    h = full_height(x, h)
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if k < s or conv.dilation[0] != 1:
        raise NotImplementedError("split-height transposed convolutions take kernel >= stride, "
                                  "dilation 1")
    _, me, n = collectives.axis("spatial")
    windows, cuts = [], []
    for o0, o1 in (rows(conv_transpose_height(h, conv), q, n) for q in range(n)):
        a = -((-(o0 + p - k + 1)) // s)  # ceil
        windows.append((a, max(a, (o1 - 1 + p) // s + 1)))
        cuts.append((o0 + p - a * s, o1 - o0))
    slab = exchange(x, h, windows, "zero")
    y = _valid_rows(lambda t: F.conv_transpose2d(
        t, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]), (0, conv.output_padding[1]),
        conv.groups, conv.dilation), slab, 1)
    return y.narrow(2, *cuts[me]) if y.shape[2] else y


# ---------------------------------------------------------------------------
# resizes and pools
# ---------------------------------------------------------------------------


def nearest_resize_plain(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW with ``F.interpolate(mode="nearest")``'s
    floor convention, src = floor(dst · in / out), in integer arithmetic;
    an exact-factor shrink is a strided slice, an exact-factor enlargement
    a repeat."""
    in_h, in_w = x.shape[2], x.shape[3]
    if (in_h, in_w) == (h, w):
        return x
    if in_h % h == 0 and in_w % w == 0:
        return x[:, :, :: in_h // h, :: in_w // w]
    if h % in_h == 0 and w % in_w == 0:
        return x.repeat_interleave(h // in_h, dim=2).repeat_interleave(w // in_w, dim=3)
    rows_ = torch.arange(h, device=x.device) * in_h // h
    cols = torch.arange(w, device=x.device) * in_w // w
    return x.index_select(2, rows_).index_select(3, cols)


def _pick(x: torch.Tensor, dim: int, idx: Sequence[int]) -> torch.Tensor:
    """Entries ``idx`` of x along ``dim``: a slice where they are evenly
    spaced, a repeat where each of a run of entries repeats f times (as
    ``nearest_resize_plain`` takes them), a gather otherwise."""
    n = len(idx)
    if n == 0:
        return x.narrow(dim, 0, 0)
    a, step = idx[0], (idx[1] - idx[0] if n > 1 else 1)
    if step > 0 and list(idx) == list(range(a, a + step * n, step)):
        span = x.narrow(dim, a, step * (n - 1) + 1)
        return span[(slice(None),) * dim + (slice(None, None, step),)]
    f = idx.count(a)
    if n % f == 0 and list(idx) == [a + j // f for j in range(n)]:
        return x.narrow(dim, a, n // f).repeat_interleave(f, dim=dim)
    return x.index_select(dim, _index(tuple(idx), str(x.device)))


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int,
                   h: Optional[int] = None) -> torch.Tensor:
    """``nearest_resize_plain(x, out_h, out_w)`` of an activation whose
    height is split: this rank's output rows, row i read from input row
    ⌊i·h/out_h⌋ of the window of rows it fetches (``exchange``; with
    heights that divide, as in the generator's 2x upsampling, its own rows
    and no collective).  ``h``: x's global height where known."""
    if not active():
        return nearest_resize_plain(x, out_h, out_w)
    h = full_height(x, h)
    _, me, n = collectives.axis("spatial")
    windows = []
    for o0, o1 in (rows(out_h, q, n) for q in range(n)):
        a = o0 * h // out_h
        windows.append((a, (o1 - 1) * h // out_h + 1) if o1 > o0 else (a, a))
    slab = exchange(x, h, windows)
    o0, o1 = rows(out_h, me, n)
    y = _pick(slab, 2, [i * h // out_h - windows[me][0] for i in range(o0, o1)])
    return _pick(y, 3, [j * x.shape[3] // out_w for j in range(out_w)])


def max_pool2d(x: torch.Tensor, k: int, stride: int, h: Optional[int] = None) -> torch.Tensor:
    """``F.max_pool2d(x, k, stride)`` (no padding) over a split height: a
    rank's first output row can need its neighbour's last rows (an odd
    ⌈h/S⌉), fetched by ``halo``."""
    if not active():
        return F.max_pool2d(x, k, stride)
    slab = halo(x, full_height(x, h), k, stride, 0, 0)
    return _valid_rows(lambda t: F.max_pool2d(t, k, stride), slab, k)


def avg_pool2d(x: torch.Tensor, k: int, stride: int, pad: int,
               h: Optional[int] = None) -> torch.Tensor:
    """``F.avg_pool2d(x, k, stride, pad, count_include_pad=False)`` over a
    split height: the divisor counts only real pixels.  Rows from a
    neighbour are real, the global top and bottom pad rows are not, so the
    rank's halo window is pooled over its width padding alone and divided
    by the same pool over a map of its real rows (ones, zero on the pad
    rows)."""
    if not active():
        return F.avg_pool2d(x, k, stride, pad, count_include_pad=False)
    h = full_height(x, h)
    _, me, n = collectives.axis("spatial")
    slab = halo(x, h, k, stride, pad, pad, "zero")
    a, b = _window(*rows(out_height(h, k, stride, pad), me, n), k, stride, pad)
    real = torch.tensor([float(0 <= i < h) for i in range(a, b)], dtype=x.dtype,
                        device=x.device)
    real = real.reshape(1, 1, -1, 1).expand(1, 1, b - a, x.shape[3])

    def pool(t):
        return F.avg_pool2d(t, k, stride, (0, pad), count_include_pad=False)

    return _valid_rows(pool, slab, k) / _valid_rows(pool, real, k)
