"""The Cityscapes dataset of GauGAN/SPADE training (port of
``cat_tpu/data/cityscapes.py``).

Reference: data/cityscapes_dataset.py: gtFine ``*_labelIds.png`` and
``*_instanceIds.png`` under ``gtFine/<phase>``, leftImg8bit photos under
``leftImg8bit/<phase>``; labels and instances are resized NEAREST and kept
as raw integer ids, photos BICUBIC and normalised to [-1, 1], all to
(load_size, load_size / aspect_ratio).  The same files, order and PIL calls
as the JAX package, so the two give the same samples.

An item: ``label`` (H, W) float32 ids, ``instance`` (H, W) int32 (unless
``no_instance``), ``image`` (3, H, W) float32 in [-1, 1], ``path``.  The
one-hot semantics and the instance edges are made on the device
(``train/spade_model.py::preprocess_input``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from cat_tpu_torch.data.datasets import make_dataset, natural_sort
from cat_tpu_torch.data.loader import DataLoader


def _pair_key(path: str, suffix: str) -> str:
    return os.path.basename(path).replace(suffix, "")


class CityscapesDataset:
    def __init__(self, dataroot: str, phase: str = "train", load_size: int = 512,
                 crop_size: int = 512, aspect_ratio: float = 2.0, no_instance: bool = False,
                 pairing_check: bool = True, max_size: int = -1, load_in_memory: bool = False):
        """``crop_size`` is accepted and unused, as in the JAX package."""
        label_dir = os.path.join(dataroot, "gtFine", phase)
        files = make_dataset(label_dir)
        self.label_paths = natural_sort([p for p in files if p.endswith("_labelIds.png")])
        self.instance_paths = natural_sort([p for p in files if p.endswith("_instanceIds.png")])
        self.image_paths = natural_sort(make_dataset(os.path.join(dataroot, "leftImg8bit", phase)))
        if max_size > 0:
            self.label_paths = self.label_paths[:max_size]
            self.instance_paths = self.instance_paths[:max_size]
            self.image_paths = self.image_paths[:max_size]
        if pairing_check:
            for lp, ip in zip(self.label_paths, self.image_paths):
                if _pair_key(lp, "_gtFine_labelIds.png") != _pair_key(ip, "_leftImg8bit.png"):
                    raise ValueError(f"label-image pairing broken: {lp} vs {ip} "
                                     "(--no_pairing_check skips the check)")
        self.no_instance = no_instance
        self.size = (load_size, int(load_size / aspect_ratio))  # PIL's (w, h)
        self.cache: Optional[List[Optional[Dict]]] = (
            [None] * len(self.label_paths) if load_in_memory else None)

    def __len__(self):
        return len(self.label_paths)

    def __getitem__(self, index: int) -> Dict:
        if self.cache is not None and self.cache[index] is not None:
            return self.cache[index]
        ip = self.image_paths[index]
        label = Image.open(self.label_paths[index]).resize(self.size, Image.NEAREST)
        image = Image.open(ip).convert("RGB").resize(self.size, Image.BICUBIC)
        image = np.asarray(image, dtype=np.float32) / 127.5 - 1.0
        item = {"label": np.asarray(label, dtype=np.float32),
                "image": np.ascontiguousarray(image.transpose(2, 0, 1)), "path": ip}
        if not self.no_instance:
            inst = Image.open(self.instance_paths[index]).resize(self.size, Image.NEAREST)
            item["instance"] = np.asarray(inst, dtype=np.int32)
        if self.cache is not None:
            self.cache[index] = item
        return item


def create_cityscapes_dataloader(dataroot: str, batch_size: int, phase: str = "train",
                                 shuffle: bool = True, seed: Optional[int] = None,
                                 drop_last: bool = True, num_workers: int = 4,
                                 worker_mode: str = "thread",
                                 process_shard: Optional[Tuple[int, int]] = None,
                                 **kwargs) -> DataLoader:
    """The port's loader over ``CityscapesDataset(dataroot, phase, **kwargs)``
    (``process_shard``: ``loader.DataLoader``'s)."""
    return DataLoader(CityscapesDataset(dataroot, phase, **kwargs), batch_size, shuffle=shuffle,
                      seed=seed, drop_last=drop_last, num_workers=num_workers,
                      worker_mode=worker_mode, process_shard=process_shard)
