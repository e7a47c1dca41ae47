"""Batching loader with parallel decode, and the copy of batches to the
device one step ahead (port of ``cat_tpu/data/loader.py``).

Decoding runs in a thread pool (PIL releases the GIL while it decodes), in
worker processes, or in the C++ image pipeline; samples are stacked into
contiguous NCHW float32 tensors.
Every random draw is made serially in the consumer (the datasets'
``prepare``), so the sample stream is the same for every backend and worker
count, and the same as the JAX package's from the same folder and seed.
With ``process_shard=(rank, world)`` ``batch_size`` is the GLOBAL batch and
the loader decodes only the rank's contiguous slice of each batch, the JAX
package's rule; it still makes every draw of the whole batch, so that the
ranks' slices together are the one-process batch.
``device_prefetch`` copies the next batch from pinned memory on a side CUDA
stream while the current step runs.
"""

from __future__ import annotations

import collections
import multiprocessing
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# batches in flight ahead of the consumer
_PREFETCH = 2

# the dataset of a worker process, set by _init_worker
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch_batch(arg) -> Dict[str, Any]:
    kind, items = arg
    if kind == "tasks":  # prepared in the consumer: workers only decode
        return collate([_WORKER_DATASET.load(t) for t in items])
    return collate([_WORKER_DATASET[i] for i in items])


def collate(samples: List[Dict]) -> Dict[str, Any]:
    """Stack array fields; other fields (paths) become lists."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def _as_tensors(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = True,
        num_workers: int = 4,
        worker_mode: str = "thread",
        process_shard: Optional[Tuple[int, int]] = None,
    ):
        """``process_shard=(rank, world)``: this rank's slice of every
        global batch of ``batch_size`` (which ``world`` must divide; a
        partial last batch is dropped, since it cannot be split).

        ``worker_mode``:
          * ``"thread"``: per-sample decode over a thread pool, two batches
            in flight;
          * ``"process"``: ``num_workers`` worker processes (started with
            ``spawn`` at the first iteration, kept until ``close``), one
            batch per task;
          * ``"native"``: whole batches through the C++ image pipeline
            (``data/native.py``) on ``num_workers`` C++ threads, two batches
            in flight; the thread backend where the pipeline or the
            dataset's spec is unsupported."""
        if worker_mode not in ("thread", "process", "native"):
            raise ValueError(f"unknown worker_mode {worker_mode!r}")
        self.keep = slice(None)
        if process_shard is not None:
            rank, world = process_shard
            if batch_size % world:
                raise ValueError(f"global batch {batch_size} not divisible by {world} processes")
            if not 0 <= rank < world:
                raise ValueError(f"process {rank} of {world}")
            per = batch_size // world
            self.keep = slice(rank * per, (rank + 1) * per)
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self._pool = None
        self.rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.process_shard is not None:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last or self.process_shard is not None:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _tasks(self, b: List[int]):
        """(this rank's items of batch ``b``, whether they are prepared
        tasks for ``load`` or indices): every draw of the whole batch is
        made, in order, and the rank's slice kept."""
        prep = getattr(self.dataset, "prepare", None)
        if prep is not None:
            return [prep(i) for i in b][self.keep], True
        return b[self.keep], False

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch in self._numpy_batches():
            yield _as_tensors(batch)

    def _numpy_batches(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if self.num_workers <= 0:
            for b in batches:
                items, prepared = self._tasks(b)
                load = self.dataset.load if prepared else self.dataset.__getitem__
                yield collate([load(t) for t in items])
            return
        if self.worker_mode == "process":
            yield from self._iter_processes(batches)
            return
        if self.worker_mode == "native":
            it = self._iter_native(batches)
            if it is not None:
                yield from it
                return

        # per-sample decode fanned out over the pool, _PREFETCH batches in
        # flight; the random draws happen here, serially
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window: collections.deque = collections.deque()

            def submit(b):
                items, prepared = self._tasks(b)
                load = self.dataset.load if prepared else self.dataset.__getitem__
                return [pool.submit(load, t) for t in items]

            for b in batches[:_PREFETCH]:
                window.append(submit(b))
            for b in batches[_PREFETCH:]:
                ready = window.popleft()
                window.append(submit(b))
                yield collate([f.result() for f in ready])
            while window:
                yield collate([f.result() for f in window.popleft()])

    def _iter_native(self, batches: List[List[int]]) -> Optional[Iterator[Dict[str, Any]]]:
        """Batches through the C++ image pipeline: one submission thread
        keeps the random draws in serial order, and the ctypes call releases
        the GIL while the C++ threads decode, so ``_PREFETCH`` batches
        overlap the step.  None (the caller uses the thread backend) when
        the dataset has no native path, its spec or files are unsupported,
        or the pipeline did not build."""
        from cat_tpu_torch.data import native

        fetch = getattr(self.dataset, "native_batch", None)
        supported = getattr(self.dataset, "native_supported", None)
        if fetch is None or supported is None or not supported():
            return None
        pipe = native.load_pipe()
        if pipe is None:
            return None

        def gen():
            with ThreadPoolExecutor(max_workers=1) as pool:
                window: collections.deque = collections.deque()
                for b in batches[:_PREFETCH]:
                    window.append(pool.submit(fetch, b, pipe, self.num_workers, self.keep))
                for b in batches[_PREFETCH:]:
                    ready = window.popleft()
                    window.append(pool.submit(fetch, b, pipe, self.num_workers, self.keep))
                    yield ready.result()
                while window:
                    yield window.popleft().result()

        return gen()

    def _iter_processes(self, batches: List[List[int]]) -> Iterator[Dict[str, Any]]:
        """Batches decoded by worker processes; ``num_workers + 2`` batches
        in flight."""
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                  initargs=(self.dataset,))
        def task(b):  # the random draws stay in this process
            items, prepared = self._tasks(b)
            return ("tasks" if prepared else "indices", items)

        depth = self.num_workers + _PREFETCH
        window: collections.deque = collections.deque()
        for b in batches[:depth]:
            window.append(self._pool.apply_async(_worker_fetch_batch, (task(b),)))
        for b in batches[depth:]:
            ready = window.popleft()
            window.append(self._pool.apply_async(_worker_fetch_batch, (task(b),)))
            yield ready.get()
        while window:
            yield window.popleft().get()

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None


def device_prefetch(iterator: Iterator[Dict[str, Any]],
                    device: torch.device) -> Iterator[Dict[str, Any]]:
    """Yield ``iterator``'s batches with their tensors on ``device``.

    On CUDA each batch is copied from pinned host memory by a
    ``non_blocking`` copy on a side stream, one batch ahead of the
    consumer; the consumer's stream waits on the copy's event before it
    uses the batch.  Tensors already on the device pass through."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: v.to(device) if isinstance(v, torch.Tensor) else v
                   for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: (v.pin_memory().to(device, non_blocking=True)
                       if isinstance(v, torch.Tensor) and v.device.type == "cpu" else v)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(item):
        out, done = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(consumer)  # the allocator must not reuse it early
        return out

    buf: collections.deque = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= _PREFETCH:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())
