"""The process group of a multi-process run, and the host-side merges of
evaluation (port of ``cat_tpu/parallel/multihost.py``).

One process per device: ``initialize`` joins the group, every process
builds the same replicated state from the same seed and checkpoint, the
loader of rank r decodes only its contiguous slice of every global batch
(``process_shard``), and the evaluators take every world-th val batch and
merge what they measured with ``reduce_moments`` (FID) and ``reduce_hist``
(mIoU).

Launch:

    python -m cat_tpu_torch distill <flags> --n_devices 4          # 4 ranks, one host
    python -m cat_tpu_torch distill <flags> --num_processes 2 \\
        --process_id 0 --coordinator_address host0:29500            # one per host
    torchrun --nproc_per_node 8 -m cat_tpu_torch distill <flags> --multihost 1

``--multihost 1`` without the three flags reads the launcher's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (and ``LOCAL_RANK`` for
the device), as a TPU pod's processes find each other on their own.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _from_env(coordinator_address, num_processes, process_id):
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    return coordinator_address, num_processes, process_id


def local_rank(rank: int) -> int:
    """This process's card on its host: ``LOCAL_RANK`` where a launcher
    sets it, else the rank modulo the host's visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> None:
    """Join the process group: ``init_process_group`` over
    ``tcp://<coordinator_address>``, NCCL when this rank's ``device`` is a
    CUDA device (the card ``local_rank`` names when None), gloo on the CPU.
    Arguments left None come from the launcher's environment.  A group that
    is already up is used as it is; ``num_processes == 1`` creates none."""
    if num_processes == 1:
        return
    if dist.is_initialized():
        return
    addr, n, rank = _from_env(coordinator_address, num_processes, process_id)
    missing = [flag for flag, v in (("--coordinator_address", addr), ("--num_processes", n),
                                    ("--process_id", rank)) if v is None]
    if missing:
        raise ValueError(f"multi-process run: {', '.join(missing)} not given, and no "
                         "launcher environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) "
                         "to take them from")
    if n == 1:
        return
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank(rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: CUDA is not available; pass device='cpu' to run "
                               "the ranks on the CPU")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"tcp://{addr}", world_size=n, rank=rank,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=n, rank=rank)
    # a start-up barrier: every rank reaches its communicator now, not
    # inside its first step
    probe = torch.ones((), device=dev)
    dist.all_reduce(probe)
    if int(probe) != n:
        raise RuntimeError(f"rank {rank}: the start-up all-reduce gave {int(probe)}, not {n}")


def process_shard() -> Tuple[int, int]:
    """(rank, world size) for the data shards; (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """Whether this process writes logs, options, checkpoints and dumps
    (rank 0, or the only process)."""
    return process_shard()[0] == 0


def _host_device() -> torch.device:
    """Where the group's host-side merges run: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sum(a: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_host_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def reduce_moments(n: int, s1: Optional[np.ndarray], s2: Optional[np.ndarray]):
    """The activation moments (count, Σa, Σaaᵀ) summed over the ranks, in
    float64.  Every rank calls it once per evaluation; a rank whose share
    of the val batches was empty passes ``s1 = s2 = None``, after the ranks
    agree on the feature width."""
    d_local = 0 if s1 is None else int(s1.shape[0])
    d = int(_max(np.asarray(d_local, np.int64)))
    if s1 is None:
        s1 = np.zeros((d,), np.float64)
        s2 = np.zeros((d, d), np.float64)
    n_total = int(_sum(np.asarray([n], np.int64))[0])
    return (n_total, _sum(np.asarray(s1, np.float64)), _sum(np.asarray(s2, np.float64)))


def _max(a: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(1)).to(_host_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy()[0]


def reduce_hist(hist: np.ndarray) -> np.ndarray:
    """The confusion matrices summed over the ranks (int64)."""
    return _sum(np.asarray(hist, np.int64))


def broadcast_value(value, src: int = 0):
    """Rank ``src``'s picklable ``value`` on every rank."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src)
    return box[0]
