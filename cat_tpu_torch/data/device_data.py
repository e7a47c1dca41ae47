"""Device-resident dataset: the images live on the GPU and the random crops
and flips are drawn there (port of ``cat_tpu/data/device_data.py``).

An image-translation dataset at CycleGAN scale is small next to device
memory (horse2zebra: 2401 images x 286x286x3 uint8 = 590 MB), so the
decoded and resized uint8 images are uploaded once and every batch is cut
from them on the device: no host work and no host-to-device copy per step.

Sampling semantics are the JAX package's: independent uniform index draws
per side (A, B), a uniform crop position and a fair-coin horizontal flip
per sample, then x/255*2-1 clamped to [-1, 1].  An epoch is
``max(len(dataset) // batch, 1)`` steps, as the host loader paces it.  The
draws come from a device ``torch.Generator``, so the two packages' random
streams differ; the function of given draws is the same.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

_DECODE_THREADS = 4


def stack_resized_uint8(paths: Sequence[str], load_size: int) -> np.ndarray:
    """Decode and bicubic-resize every image once on the host -> (N, S, S, 3)
    uint8: with the C++ pipeline (``data/native.py``) where it builds, as
    the JAX package does, so the two banks hold the same pixels; else, or
    for a container the pipeline cannot read, with PIL over a thread
    pool."""
    from PIL import Image

    from cat_tpu_torch.data.native import load_pipe, native_filter_for

    pipe = load_pipe()
    if pipe is not None:
        try:
            return pipe.fill_bank(paths, load_size, nthreads=_DECODE_THREADS,
                                  filter=native_filter_for(Image.BICUBIC))
        except IOError:
            pass  # e.g. webp: PIL below

    def one(p):
        with Image.open(p) as img:
            return np.asarray(img.convert("RGB").resize((load_size, load_size),
                                                        Image.BICUBIC), np.uint8)

    out = np.empty((len(paths), load_size, load_size, 3), np.uint8)
    with ThreadPoolExecutor(max_workers=_DECODE_THREADS) as pool:
        for i, arr in enumerate(pool.map(one, paths)):
            out[i] = arr
    return out


def draw(generator: torch.Generator, n: int, bank_shape: Tuple[int, ...], crop: int,
         no_flip: bool) -> Tuple[torch.Tensor, ...]:
    """n samples' (image index, crop y, crop x, flip) from ``generator``."""
    count, h, w = bank_shape[:3]
    dev = generator.device
    idx = torch.randint(0, count, (n,), generator=generator, device=dev)
    ys = torch.randint(0, h - crop + 1, (n,), generator=generator, device=dev)
    xs = torch.randint(0, w - crop + 1, (n,), generator=generator, device=dev)
    if no_flip:
        flip = torch.zeros(n, dtype=torch.bool, device=dev)
    else:
        flip = torch.rand(n, generator=generator, device=dev) < 0.5
    return idx, ys, xs, flip


def sample_side(imgs: torch.Tensor, idx: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                flip: torch.Tensor, crop: int) -> torch.Tensor:
    """The (crop x crop) patches of the (N, H, W, C) uint8 bank at the given
    draws, mirrored where ``flip``, as an (n, C, crop, crop) float32 tensor
    in [-1, 1]."""
    r = torch.arange(crop, device=imgs.device)
    rows = ys[:, None] + r  # (n, crop)
    cols = torch.where(flip[:, None], xs[:, None] + (crop - 1) - r, xs[:, None] + r)
    patches = imgs[idx[:, None, None], rows[:, :, None], cols[:, None, :]]  # (n, crop, crop, C)
    patches = patches.permute(0, 3, 1, 2)
    # transforms.finish_transform's formula x/255*2-1, clamped as the JAX
    # package clamps it
    scaled = patches.float() / 255.0 * 2.0 - 1.0
    return scaled.clamp(-1.0, 1.0).contiguous()


class DeviceData:
    """Unaligned (A, B) uint8 image banks on the device, with batch
    sampling."""

    def __init__(self, images_a: np.ndarray, images_b: Optional[np.ndarray], crop_size: int,
                 no_flip: bool = False, device=None):
        device = torch.device("cuda" if device is None else device)
        self.imgs_a = torch.from_numpy(np.ascontiguousarray(images_a)).to(device)
        self.imgs_b = (torch.from_numpy(np.ascontiguousarray(images_b)).to(device)
                       if images_b is not None else None)
        self.device = device
        self.crop = crop_size
        self.no_flip = no_flip

    @classmethod
    def from_unaligned(cls, dataroot: str, phase: str, load_size: int, crop_size: int,
                       no_flip: bool = False, max_size: int = -1, device=None):
        from cat_tpu_torch.data.datasets import make_dataset

        pa = make_dataset(os.path.join(dataroot, phase + "A"), max_size)
        pb = make_dataset(os.path.join(dataroot, phase + "B"), max_size)
        return cls(stack_resized_uint8(pa, load_size), stack_resized_uint8(pb, load_size),
                   crop_size, no_flip, device), max(len(pa), len(pb))

    def _side(self, imgs: torch.Tensor, generator: torch.Generator, n: int) -> torch.Tensor:
        return sample_side(imgs, *draw(generator, n, imgs.shape, self.crop, self.no_flip),
                           self.crop)

    def sample(self, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
        out = {"A": self._side(self.imgs_a, generator, batch)}
        if self.imgs_b is not None:
            out["B"] = self._side(self.imgs_b, generator, batch)
        return out

    def batches(self, seed: int, batch: int, steps: int) -> Iterator[Dict[str, torch.Tensor]]:
        """``steps`` sampled batches (one epoch of the host loader's pacing)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for _ in range(steps):
            yield self.sample(gen, batch)


class DeviceDataLoader:
    """Trainer-facing loader over ``DeviceData``: ``len(dataset) // batch``
    steps per epoch, each epoch from a fresh seed.  Its batches are already
    on the device.  Over several ranks every rank draws the whole global
    batch of ``batch`` and keeps its slice (``process_shard=(rank,
    world)``) and, of each image, its rows (``height_shard=(s, S)``), as
    the host loader does."""

    def __init__(self, dd: DeviceData, batch: int, steps_per_epoch: int, seed: int = 0,
                 process_shard: Optional[Tuple[int, int]] = None,
                 height_shard: Optional[Tuple[int, int]] = None):
        self.dd = dd
        self.batch = batch
        self.steps = steps_per_epoch
        self.seed = seed
        self.keep = slice(None)
        if process_shard is not None:
            rank, world = process_shard
            if batch % world:
                raise ValueError(f"global batch {batch} not divisible by {world} processes")
            per = batch // world
            self.keep = slice(rank * per, (rank + 1) * per)
        self.height_shard = height_shard
        self._epoch = 0

    def __len__(self):
        return self.steps

    def __iter__(self):
        from cat_tpu_torch.data.loader import height_rows

        epoch = self._epoch
        self._epoch += 1
        for b in self.dd.batches(self.seed + 1000 * epoch, self.batch, self.steps):
            yield height_rows({k: v[self.keep] for k, v in b.items()}, self.height_shard)
