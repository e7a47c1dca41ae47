"""The collectives inside a parallel step.

Every rank runs the same step on its share of the global batch, so that the
ranks together compute the single-device function of the global batch, as
the JAX package's GSPMD step over its mesh does.  The world is a
``(data, spatial)`` grid (``set_layout``; ``cat_tpu/parallel/mesh.py:38-69``):
rank r is data index r // S and spatial index r % S, holds the batch rows of
its data index and, of each image, the height rows of its spatial index
(``parallel/spatial.py``).  Without ``--n_spatial`` (S = 1) the data axis is
the world.  Each collective names its axis: ``"world"``, ``"data"`` (the
ranks that share a spatial index) or ``"spatial"`` (the ranks that share a
data index), each a group of its own:

  * ``all_reduce_sum``: batch-norm sums over the world
    (``ops/nn.py::Norm2d``, ``models/spade.py``), instance-norm plane sums
    and the gradient penalty's per-sample sums over the spatial axis, with
    its gradient (the backward all-reduces the incoming gradient);
  * ``all_gather_rows``: the rows of every rank of the data axis in order,
    for KA over the global batch (``distill/ka.py``) and the CycleGAN pool's
    query (``train/cyclegan.py``).  Its backward returns this rank's slice
    of the incoming gradient times the axis size, with no collective: every
    rank computes the same value from the same gathered rows, so the
    incoming gradient is the same on every rank, and once the parameter
    gradients are averaged (``train/common.py::average_grads``) each row's
    gradient counts once;
  * ``local_rows`` and ``local_height``: this rank's batch rows and height
    rows of a tensor every rank holds whole (the random draws over the
    global batch: dropout masks, the penalty's mixing weights, the pool's
    draws); ``gather_height`` joins the height rows of the spatial axis.

They run whenever a process group is up, world size 1 included, and not
inside ``local()`` (the evaluation sweeps, whose ranks take different
batches of whole images).  Without a group each returns its input.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_local_depth = 0


@dataclass(frozen=True)
class _Layout:
    n_spatial: int
    n_data: int
    data_index: int
    spatial_index: int
    data: Any  # the group of this rank's data axis
    spatial: Any  # the group of this rank's spatial axis
    meta: Any  # a gloo group over the spatial axis, for host integers
    world: Any  # the default group the layout was made in


_layout: Optional[_Layout] = None


def set_layout(n_spatial: int) -> None:
    """Split the world into the ``(data, spatial)`` grid of ``n_spatial``
    spatial ranks: every rank calls it once the group is up, with the same
    value (it creates the axes' groups, in the same order everywhere).
    Idempotent; ``n_spatial == 1`` keeps the data axis the world."""
    global _layout
    if not (dist.is_available() and dist.is_initialized()) or n_spatial == 1:
        _layout = None
        return
    if _current() is not None and _layout.n_spatial == n_spatial:
        return
    rank, n = dist.get_rank(), dist.get_world_size()
    if n_spatial < 1 or n % n_spatial:
        raise ValueError(f"n_spatial={n_spatial} must divide the device count ({n}); pass "
                         "--n_devices to use a subset")
    n_data = n // n_spatial
    data = [dist.new_group([d * n_spatial + s for d in range(n_data)])
            for s in range(n_spatial)]
    spatial = [dist.new_group([d * n_spatial + s for s in range(n_spatial)])
               for d in range(n_data)]
    meta = [dist.new_group([d * n_spatial + s for s in range(n_spatial)], backend="gloo")
            for d in range(n_data)]
    d, s = divmod(rank, n_spatial)
    _layout = _Layout(n_spatial, n_data, d, s, data[s], spatial[d], meta[d], dist.group.WORLD)


def _current() -> Optional[_Layout]:
    """The layout, unless the group it was made in is gone."""
    if _layout is None or not dist.is_initialized() or _layout.world is not dist.group.WORLD:
        return None
    return _layout


def axis(name: str) -> Tuple[Any, int, int]:
    """(group, this rank's index on it, its size) of axis ``name``:
    ``"world"``, ``"data"`` or ``"spatial"``; (None, 0, 1) for every axis
    while the collectives are off.  The group None is the default one."""
    if not active():
        return None, 0, 1
    lay = _current()
    if name == "world" or (name == "data" and lay is None):
        return None, dist.get_rank(), dist.get_world_size()
    if name == "data":
        return lay.data, lay.data_index, lay.n_data
    if name == "spatial":
        return (None, 0, 1) if lay is None else (lay.spatial, lay.spatial_index, lay.n_spatial)
    raise ValueError(f"unknown axis {name!r}")


def meta_group():
    """A gloo group over this rank's spatial axis: sums of host integers
    (heights, counts) without a device round trip."""
    return _current().meta


def active() -> bool:
    """Whether the step's collectives run: a process group is up and no
    ``local()`` block holds them."""
    return _local_depth == 0 and dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@contextmanager
def local():
    """Within the block the step's collectives are off: each rank computes
    on its own tensors alone (the evaluation sweeps)."""
    global _local_depth
    _local_depth += 1
    try:
        yield
    finally:
        _local_depth -= 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank's output depended on this rank's input
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, axis_name: str = "world") -> torch.Tensor:
    """The sum of ``x`` over the ranks of an axis, differentiable (twice,
    for the gradient penalty through a normalised D)."""
    group, _, n = axis(axis_name)
    if n == 1 and axis_name != "world" or not active():
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``x`` summed in place over the ranks of an axis, outside autograd."""
    group, _, n = axis(axis_name)
    if n > 1:
        dist.all_reduce(x, group=group)
    return x


def _gather(x: torch.Tensor, group, n: int, dim: int = 0) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.n = rank, n
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        b = g.shape[0] // ctx.n
        return g[ctx.rank * b:(ctx.rank + 1) * b] * ctx.n, None, None, None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows (leading axis) of every rank's ``x`` on the data axis, in
    rank order.  With a gradient, for a use that every rank computes the
    same from the gathered rows (see the module's docstring)."""
    group, rank, n = axis("data")
    if n == 1:
        return x
    if not x.requires_grad:
        with torch.no_grad():
            return _gather(x, group, n)
    return _GatherRows.apply(x, group, rank, n)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of rows of ``x``, a tensor every rank
    holds whole (the rank's share of the global batch)."""
    _, rank, n = axis("data")
    if n == 1:
        return x
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def global_rows(n_local: int) -> int:
    """Rows of the global batch whose rank holds ``n_local``."""
    return n_local * axis("data")[2]


def local_height(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's height rows (``parallel/spatial.py::rows``) of ``x``, a
    tensor every rank holds at full height."""
    from cat_tpu_torch.parallel.spatial import rows

    _, s, n = axis("spatial")
    if n == 1:
        return x
    start, stop = rows(x.shape[dim], s, n)
    return x.narrow(dim, start, stop - start)


@torch.no_grad()
def gather_height(x: torch.Tensor, height: int) -> torch.Tensor:
    """The full-height tensor of ``height`` rows whose dim 2 this rank's
    ``x`` holds its rows of, joined over the spatial axis (no gradient)."""
    from cat_tpu_torch.parallel.spatial import rows

    group, _, n = axis("spatial")
    if n == 1:
        return x
    c = rows(height, 0, n)[1]  # the most rows a rank holds
    pad = x.new_zeros((*x.shape[:2], c - x.shape[2], *x.shape[3:]))
    parts = _gather(torch.cat([x, pad], 2), group, n, dim=2).split(c, 2)
    return torch.cat([p[:, :, :stop - start] for p, (start, stop) in
                      zip(parts, (rows(height, q, n) for q in range(n)))], 2)


def buckets(tensors: Sequence[torch.Tensor], max_bytes: Optional[int] = None) -> List[List[int]]:
    """Indices of ``tensors`` grouped by (device, dtype), each group cut into
    buckets of at most ``max_bytes`` (a larger tensor alone): what one
    flattened collective can carry."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = []
    for idx in groups.values():
        out.append([])
        size = 0
        for i in idx:
            nbytes = tensors[i].numel() * tensors[i].element_size()
            if out[-1] and max_bytes is not None and size + nbytes > max_bytes:
                out.append([])
                size = 0
            out[-1].append(i)
            size += nbytes
    return out


def unflatten(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``tensors``, in order."""
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, one flattened
    broadcast per (device, dtype)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    tensors = list(tensors)
    for idx in buckets(tensors):
        group = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        torch._foreach_copy_(group, unflatten(flat, group))


def module_tensors(*modules: torch.nn.Module) -> List[torch.Tensor]:
    """The parameters and buffers of ``modules``, each tensor once."""
    seen, out = set(), []
    for m in modules:
        if m is None:
            continue
        for t in [*m.parameters(), *m.buffers()]:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def check_same(obj: Any, what: str) -> None:
    """Raise unless every rank holds the same JSON-able ``obj``."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    mine = json.dumps(obj, sort_keys=True)
    objs: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(objs, mine)
    differ = [r for r, o in enumerate(objs) if o != objs[0]]
    if differ:
        raise RuntimeError(f"{what} differs between rank 0 and rank(s) {differ}: the replicas "
                           "must be built from the same flags, files and seed")
