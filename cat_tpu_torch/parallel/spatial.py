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


def conv_height(h: Optional[int], conv) -> Optional[int]:
    """The output height of ``conv`` (an ``nn.Conv2d``) over height ``h``."""
    if h is None:
        return None
    return (h + 2 * conv.padding[0] - conv.dilation[0] * (conv.kernel_size[0] - 1) - 1) \
        // conv.stride[0] + 1


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


def _output_rows(h_out: int, n: int):
    """Every shard's rows of an output height; raises where one is empty."""
    out = [rows(h_out, q, n) for q in range(n)]
    for q, (o0, o1) in enumerate(out):
        if o1 <= o0:
            raise ValueError(f"a height of {h_out} over {n} spatial ranks leaves rank {q} no "
                             "rows: use fewer spatial ranks or larger images")
    return out


def halo(x: torch.Tensor, h: int, k: int, stride: int, top: int, bottom: int,
         mode: str = "zero") -> torch.Tensor:
    """The rows that a valid convolution of kernel height ``k`` and
    ``stride`` over x (global height ``h``) padded by ``top`` and ``bottom``
    rows (``mode``) turns into this rank's rows of its output."""
    _, _, n = collectives.axis("spatial")
    h_out = (h + top + bottom - k) // stride + 1
    return exchange(x, h, [(o0 * stride - top, (o1 - 1) * stride + k - top)
                           for o0, o1 in _output_rows(h_out, n)], mode)


def conv2d(conv, x: torch.Tensor, h: Optional[int] = None) -> torch.Tensor:
    """``conv(x)`` (an ``nn.Conv2d`` with zero padding) over a split height:
    the height padding comes from the neighbours and is zero only at the
    global top and bottom; the width keeps its own."""
    if conv.dilation[0] != 1 or conv.padding_mode != "zeros":
        raise NotImplementedError("split-height convolutions take dilation 1, zero padding")
    slab = halo(x, full_height(x, h), conv.kernel_size[0], conv.stride[0], conv.padding[0],
                conv.padding[0], "zero")
    return F.conv2d(slab, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


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
    for o0, o1 in _output_rows(conv_transpose_height(h, conv), n):
        a = -((-(o0 + p - k + 1)) // s)  # ceil
        windows.append((a, (o1 - 1 + p) // s + 1))
        cuts.append((o0 + p - a * s, o1 - o0))
    slab = exchange(x, h, windows, "zero")
    y = F.conv_transpose2d(slab, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                           (0, conv.output_padding[1]), conv.groups, conv.dilation)
    return y.narrow(2, *cuts[me])
