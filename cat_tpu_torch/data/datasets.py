"""Datasets: aligned (pix2pix AB pairs), unaligned (CycleGAN), single (eval)
(port of ``cat_tpu/data/datasets.py``); ``create_dataloader``'s
``cityscapes`` mode builds ``data/cityscapes.py``'s dataset of the SPADE
family.

The same files, random draws (in the same order) and PIL calls as the JAX
package, so the two give the same samples from the same folder and seed.
A sample's images are float32 CHW arrays in [-1, 1] (the JAX package's are
HWC); the loader stacks them into NCHW batches.
"""

from __future__ import annotations

import copy
import os
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from cat_tpu_torch.data.loader import DataLoader
from cat_tpu_torch.data.native import native_filter_for
from cat_tpu_torch.data.transforms import (TransformSpec, apply_transform, chw, finish_transform,
                                           get_params, resize_image)

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def natural_sort(items: List[str]) -> List[str]:
    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]

    return sorted(items, key=key)


def make_dataset(directory: str, max_size: int = -1) -> List[str]:
    """Recursive image scan (reference data/image_folder.py:40-72)."""
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if fname.lower().endswith(IMG_EXTENSIONS):
                images.append(os.path.join(root, fname))
    images = natural_sort(images)
    if max_size > 0:
        images = images[:max_size]
    return images


class _ImageCache:
    """Optional decoded+resized image cache (--load_in_memory): resize is
    deterministic per (path, spec), and decode + resize is most of the
    per-sample host cost."""

    def __init__(self, enabled: bool):
        self.store: Optional[Dict[tuple, tuple]] = {} if enabled else None

    def open(self, path: str) -> Image.Image:
        if self.store is None:
            return Image.open(path)
        # keys are namespaced per accessor: open() and open_resized() cache
        # different payloads for the same path
        ent = self.store.get(("raw", path))
        if ent is None:
            img = Image.open(path)
            img.load()
            self.store[("raw", path)] = (img,)
            return img
        return ent[0]

    def open_resized(self, path: str, spec) -> tuple:
        """(resized PIL image, original (w, h)), cached when enabled."""
        if self.store is None:
            img = Image.open(path)
            return resize_image(img, spec), img.size
        ent = self.store.get(("resized", path))
        if ent is None:
            img = Image.open(path)
            ent = (resize_image(img, spec), img.size)
            self.store[("resized", path)] = ent
        return ent


def _image_size(path: str, cache: _ImageCache, spec=None):
    """(w, h) from the container header, without decoding the pixels; for
    ``resize_and_crop`` the size never feeds the transform params, so the
    header is not read at all."""
    if spec is not None and spec.preprocess == "resize_and_crop":
        return (spec.load_size, spec.load_size)  # unused by get_params
    if cache.store is not None:
        ent = cache.store.get(("resized", path))
        if ent is not None:
            return ent[1]
    with Image.open(path) as im:
        return im.size


class AlignedDataset:
    """AB side-by-side images split in half; A and B share transform params
    (reference data/aligned_dataset.py:32-58)."""

    def __init__(self, dataroot: str, phase: str = "train",
                 spec: Optional[TransformSpec] = None,
                 direction: str = "AtoB", max_size: int = -1,
                 seed: Optional[int] = None, load_in_memory: bool = False):
        self.dir_AB = os.path.join(dataroot, phase)
        self.paths = make_dataset(self.dir_AB, max_size)
        self.spec = spec or TransformSpec()
        self.direction = direction
        self.rng = random.Random(seed)
        self.cache = _ImageCache(load_in_memory)

    def __len__(self):
        return len(self.paths)

    def prepare(self, index: int):
        """Serial stage: every random draw of this sample, in the order
        direct iteration makes them.  ``load`` is then pure, so every worker
        backend yields the same stream."""
        path = self.paths[index]
        w, h = _image_size(path, self.cache, self.spec)
        return (path, get_params(self.spec, (w // 2, h), self.rng))

    def load(self, task) -> Dict:
        path, params = task
        ab = self.cache.open(path).convert("RGB")
        w, h = ab.size
        w2 = w // 2
        a_arr = apply_transform(ab.crop((0, 0, w2, h)), self.spec, params)
        b_arr = apply_transform(ab.crop((w2, 0, w, h)), self.spec, params)
        if self.direction == "BtoA":
            a_arr, b_arr = b_arr, a_arr
        return {"A": chw(a_arr), "B": chw(b_arr), "A_paths": path, "B_paths": path}

    def __getitem__(self, index: int) -> Dict:
        return self.load(self.prepare(index))


class UnalignedDataset:
    """trainA/trainB with random B pairing unless serial
    (reference data/unaligned_dataset.py:47-72)."""

    def __init__(self, dataroot: str, phase: str = "train",
                 spec: Optional[TransformSpec] = None,
                 serial_batches: bool = False, max_size: int = -1,
                 seed: Optional[int] = None, load_in_memory: bool = False):
        self.paths_A = make_dataset(os.path.join(dataroot, phase + "A"), max_size)
        self.paths_B = make_dataset(os.path.join(dataroot, phase + "B"), max_size)
        self.spec = spec or TransformSpec()
        self.serial = serial_batches
        self.rng = random.Random(seed)
        self.cache = _ImageCache(load_in_memory)

    def __len__(self):
        return max(len(self.paths_A), len(self.paths_B))

    def prepare(self, index: int):
        """Serial stage: B pairing and crop/flip draws, in the order direct
        iteration makes them."""
        path_a = self.paths_A[index % len(self.paths_A)]
        if self.serial:
            path_b = self.paths_B[index % len(self.paths_B)]
        else:
            path_b = self.paths_B[self.rng.randint(0, len(self.paths_B) - 1)]
        prm_a = get_params(self.spec, _image_size(path_a, self.cache, self.spec), self.rng)
        prm_b = get_params(self.spec, _image_size(path_b, self.cache, self.spec), self.rng)
        return (path_a, path_b, prm_a, prm_b)

    def load(self, task) -> Dict:
        path_a, path_b, prm_a, prm_b = task
        a, _ = self.cache.open_resized(path_a, self.spec)
        b, _ = self.cache.open_resized(path_b, self.spec)
        return {
            "A": chw(finish_transform(a, self.spec, prm_a)),
            "B": chw(finish_transform(b, self.spec, prm_b)),
            "A_paths": path_a, "B_paths": path_b,
        }

    def __getitem__(self, index: int) -> Dict:
        return self.load(self.prepare(index))

    def native_supported(self) -> bool:
        """The C++ batch fetcher covers the training default: RGB
        resize_and_crop with a bilinear or bicubic filter over JPEG and PNG
        files.  Any other container makes the whole loader use PIL from the
        start, not mid-epoch."""
        s = self.spec
        ok_files = all(p.lower().endswith((".jpg", ".jpeg", ".png"))
                       for p in self.paths_A + self.paths_B)
        return (ok_files and s.preprocess == "resize_and_crop" and not s.grayscale
                and s.aspect_ratio == 1.0 and native_filter_for(s.method) is not None)

    def native_batch(self, indices: List[int], pipe, nthreads: int,
                     keep: slice = slice(None)) -> Dict:
        """A collated batch through the C++ pipeline, as NCHW arrays.  The
        path, crop and flip draws come from ``prepare``, in the order serial
        iteration makes them, so the sample stream is the other backends';
        the pixels are the JAX package's native backend's.  Only the samples
        ``keep`` selects are decoded (a rank's slice); the draws are made for
        all of ``indices``."""
        spec = self.spec
        paths: List[str] = []
        cx, cy, fl = [], [], []
        for path_a, path_b, prm_a, prm_b in [self.prepare(i) for i in indices][keep]:
            for p, prm in ((path_a, prm_a), (path_b, prm_b)):
                paths.append(p)
                cx.append(prm.crop_pos[0])
                cy.append(prm.crop_pos[1])
                fl.append(prm.flip)
        out = pipe.fetch_batch(paths, spec.load_size, spec.crop_size, np.asarray(cx),
                               np.asarray(cy), np.asarray(fl, np.uint8), nthreads=nthreads,
                               filter=native_filter_for(spec.method))
        return {"A": np.ascontiguousarray(out[0::2].transpose(0, 3, 1, 2)),
                "B": np.ascontiguousarray(out[1::2].transpose(0, 3, 1, 2)),
                "A_paths": paths[0::2], "B_paths": paths[1::2]}


class SingleDataset:
    """One-directory loader for evaluation (reference data/single_dataset.py)."""

    def __init__(self, dataroot: str, phase: str = "valA",
                 spec: Optional[TransformSpec] = None, max_size: int = -1):
        root = os.path.join(dataroot, phase)
        if not os.path.isdir(root):
            root = dataroot
        self.paths = make_dataset(root, max_size)
        self.spec = spec or TransformSpec()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict:
        path = self.paths[index]
        return {"A": chw(apply_transform(Image.open(path), self.spec, None)), "A_paths": path}


# ---------------------------------------------------------------------------
# loader factories (reference data/__init__.py:35-65)
# ---------------------------------------------------------------------------


def create_dataloader(
    dataset_mode: str,
    dataroot: str,
    batch_size: int,
    spec: Optional[TransformSpec] = None,
    phase: str = "train",
    direction: str = "AtoB",
    serial_batches: bool = False,
    max_size: int = -1,
    seed: Optional[int] = None,
    drop_last: bool = True,
    load_in_memory: bool = False,
    num_workers: int = 4,
    worker_mode: str = "thread",
    process_shard: Optional[Tuple[int, int]] = None,
) -> DataLoader:
    """The training loader (``process_shard``: ``loader.DataLoader``'s)."""
    if dataset_mode == "aligned":
        ds = AlignedDataset(dataroot, phase, spec, direction, max_size, seed, load_in_memory)
    elif dataset_mode == "unaligned":
        ds = UnalignedDataset(dataroot, phase, spec, serial_batches, max_size, seed,
                              load_in_memory)
    elif dataset_mode == "single":
        ds = SingleDataset(dataroot, phase, spec, max_size)
    elif dataset_mode == "cityscapes":
        from cat_tpu_torch.data.cityscapes import CityscapesDataset

        spec = spec or TransformSpec()
        ds = CityscapesDataset(dataroot, phase, spec.load_size, spec.crop_size,
                               spec.aspect_ratio, max_size=max_size,
                               load_in_memory=load_in_memory)
    else:
        raise NotImplementedError(f"dataset mode [{dataset_mode}] not implemented")
    return DataLoader(ds, batch_size, shuffle=not serial_batches, seed=seed,
                      drop_last=drop_last, num_workers=num_workers, worker_mode=worker_mode,
                      process_shard=process_shard)


def create_eval_dataloader(
    dataset_mode: str,
    dataroot: str,
    eval_batch_size: int,
    spec: Optional[TransformSpec] = None,
    direction: str = "AtoB",
    phase: str = "val",
    max_size: int = -1,
) -> DataLoader:
    """Validation loader: serial, no flip; unaligned switches to single mode
    on val{A,B} (reference data/__init__.py:50-65)."""
    spec = copy.deepcopy(spec) or TransformSpec()
    spec.no_flip = True
    if dataset_mode == "unaligned":
        sub = phase + ("A" if direction == "AtoB" else "B")
        ds = SingleDataset(dataroot, sub, spec, max_size)
    elif dataset_mode == "aligned":
        ds = AlignedDataset(dataroot, phase, spec, direction, max_size, seed=0)
    elif dataset_mode == "single":
        ds = SingleDataset(dataroot, phase, spec, max_size)
    else:
        raise NotImplementedError(dataset_mode)
    return DataLoader(ds, eval_batch_size, shuffle=False, drop_last=False)
