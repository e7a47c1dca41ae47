"""The collectives inside a data-parallel step.

Every rank runs the same step on its slice of the global batch, so that the
ranks together compute the single-device function of the global batch, as
the JAX package's GSPMD step over a batch-sharded mesh does:

  * ``all_reduce_sum``: batch-norm sums over the global batch
    (``ops/nn.py::Norm2d``, ``models/spade.py``), with its gradient (the
    backward all-reduces the incoming gradient);
  * ``all_gather_rows``: the rows of every rank in rank order, for KA over
    the global batch (``distill/ka.py``) and the CycleGAN pool's query
    (``train/cyclegan.py``).  Its backward returns this rank's slice of the
    incoming gradient times the world size, with no collective: every rank
    computes the same value from the same gathered rows, so the incoming
    gradient is the same on every rank, and once the parameter gradients are
    averaged (``train/common.py::average_grads``) each row's gradient counts
    once;
  * ``local_rows``: this rank's rows of a tensor every rank holds whole
    (the random draws over the global batch: dropout masks, the penalty's
    mixing weights, the pool's draws).

They run whenever a process group is up, world size 1 included, and not
inside ``local()`` (the evaluation sweeps, whose ranks take different
batches).  Without a group each returns its input.
"""

from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_local_depth = 0


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
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank's output depended on this rank's input
        return _AllReduceSum.apply(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (twice, for the
    gradient penalty through a batch-norm D)."""
    if not active():
        return x
    return _AllReduceSum.apply(x)


def _gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.world = dist.get_rank(), dist.get_world_size()
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        b = g.shape[0] // ctx.world
        return g[ctx.rank * b:(ctx.rank + 1) * b] * ctx.world


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows (leading axis) of every rank's ``x``, in rank order.  With a
    gradient, for a use that every rank computes the same from the gathered
    rows (see the module's docstring)."""
    if not active():
        return x
    if not x.requires_grad:
        with torch.no_grad():
            return _gather(x)
    return _GatherRows.apply(x)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of rows of ``x``, a tensor every rank
    holds whole (the rank's share of the global batch)."""
    if not active():
        return x
    rank, n = world()
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def global_rows(n_local: int) -> int:
    """Rows of the global batch whose rank holds ``n_local``."""
    return n_local * (world()[1] if active() else 1)


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
