"""The devices of a parallel run on one host (port of
``cat_tpu/parallel/mesh.py``'s ``(data, spatial)`` mesh).

``--n_devices k --n_spatial S`` runs k·S ranks, one process each
(``spawn``): rank r on ``cuda:r`` (or every rank on the CPU, or on one
device the caller names), meeting on a free local port.  Rank r is data
index r // S and spatial index r % S, as in the JAX package's grid
(``collectives.set_layout`` makes the axes' groups); the spatial axis
splits image height (``parallel/spatial.py``), for the inception and the
SPADE family.  ``--n_devices 1
--n_spatial 1``, the default, is one process with no group.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def n_ranks(n_devices: int, device=None, n_spatial: int = 1) -> int:
    """The ranks ``--n_devices`` and ``--n_spatial`` ask for, k·S: k = 0
    means the visible cards divided by S (``cat_tpu/entry.py:114``).
    Raises, as the JAX package's ``make_mesh`` does, when more are asked
    for than there are cards; ranks on the CPU (``device="cpu"``) need a
    count."""
    if n_spatial < 1:
        raise ValueError(f"--n_spatial must be at least 1, got {n_spatial}")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        if n_devices < 1:
            raise ValueError("--n_devices 0 means every visible card; ranks on the CPU need "
                             "a count")
        return n_devices * n_spatial
    visible = torch.cuda.device_count()
    n = (visible // n_spatial if n_devices <= 0 else n_devices) * n_spatial
    if n > visible or n < 1:
        raise ValueError(f"requested {max(n, n_spatial)} devices but only {visible} available")
    return n


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, fn: Callable, world: int, port: int, device, backend: Optional[str],
               args: Sequence) -> None:
    from cat_tpu_torch.parallel import multihost

    # cuda:rank, unless the caller named one device (the CPU, or one card
    # that every rank shares)
    dev = torch.device("cuda", rank) if device is None else torch.device(device)
    if dev.type == "cpu":  # the host's cores shared out between its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if backend is None:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device=dev)
    else:  # e.g. gloo for ranks that share one card, which NCCL refuses
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
    try:
        fn(dev, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device=None,
          backend: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks in one process
    group, rank r on ``cuda:r`` or all on ``device`` where given (NCCL on
    cards, gloo on the CPU, unless ``backend`` says otherwise).  Returns when every rank has returned;
    raises when a rank fails (the others are ended), or, with ``timeout``
    seconds, when the ranks have not all returned by then (all are
    ended).  ``fn`` must be importable by name: the ranks are fresh
    interpreters."""
    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), device, backend,
                                               tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(None if deadline is None else max(deadline - time.monotonic(), 0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
