"""The generic SPADE dataset base and the custom-dataset template (port of
``cat_tpu/data/spade_generic.py``).

Reference: data/spade_dataset.py (the abstract ``SPADEDataset``: subclasses
give ``get_paths``/``paths_match``; the base sorts naturally, checks the
label-image pairing, crops and flips label, instance and image with shared
random parameters, caches decoded images and remaps the 255 'unknown'
label to ``input_nc``) and data/template_dataset.py (the starting point of
a custom dataset).  ``data/cityscapes.py`` stays standalone, as in the JAX
package.

An item: ``label`` (H, W) float32 raw ids, ``instance`` (H, W) int32 (unless
``no_instance``), ``image`` (3, H, W) float32 in [-1, 1] (the JAX package's
is HWC), ``path``; the one-hot semantics and edges are made on the device
(``train/spade_model.py::preprocess_input``).  The same files, PIL calls and
random draws as the JAX package, so a folder and seed give the same items.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from cat_tpu_torch.data.datasets import make_dataset, natural_sort
from cat_tpu_torch.data.transforms import TransformParams, TransformSpec, get_params, resize_image


class SPADEDataset:
    """Abstract label + image (+ instance) dataset of the SPADE family.

    Subclasses implement ``get_paths`` (and usually ``paths_match``).  The
    cache (``load_in_memory``) holds the decoded and resized PIL images
    only: the random crop and flip are drawn again at every access, as the
    reference does (spade_dataset.py:41-66)."""

    def __init__(self, dataroot: str, phase: str = "train", spec: Optional[TransformSpec] = None,
                 input_nc: int = 35, no_instance: bool = False, pairing_check: bool = True,
                 contain_dontcare_label: bool = True, max_size: int = -1,
                 load_in_memory: bool = False, seed: Optional[int] = None):
        self.dataroot, self.phase = dataroot, phase
        self.spec = spec or TransformSpec(preprocess="scale_width_and_crop", load_size=512,
                                          crop_size=512)
        self.input_nc = input_nc
        self.no_instance = no_instance
        self.contain_dontcare_label = contain_dontcare_label
        self._rng = random.Random(seed) if seed is not None else None

        label_paths, image_paths, instance_paths = self.get_paths()
        label_paths = natural_sort(list(label_paths))
        image_paths = natural_sort(list(image_paths))
        instance_paths = natural_sort(list(instance_paths or []))
        if max_size > 0:
            label_paths, image_paths = label_paths[:max_size], image_paths[:max_size]
            instance_paths = instance_paths[:max_size]
        if pairing_check:
            for lp, ip in zip(label_paths, image_paths):
                assert self.paths_match(lp, ip), (
                    f"label-image pair ({lp}, {ip}) do not look paired; override paths_match "
                    "or pass pairing_check=False")
        if not no_instance and len(instance_paths) != len(label_paths):
            raise ValueError(f"no_instance=False but {len(instance_paths)} instance maps were "
                             f"found for {len(label_paths)} labels: provide a matching instance "
                             "set (e.g. <phase>_instances) or pass no_instance=True")
        self.label_paths, self.image_paths = label_paths, image_paths
        self.instance_paths = instance_paths
        self.cache: Optional[List[Optional[Tuple]]] = (
            [None] * len(label_paths) if load_in_memory else None)

    # -- subclass hooks ----------------------------------------------------
    def get_paths(self) -> Tuple[List[str], List[str], List[str]]:
        """(label_paths, image_paths, instance_paths)."""
        raise NotImplementedError

    def paths_match(self, label_path: str, image_path: str) -> bool:
        """By default, the same file stem."""
        return (os.path.splitext(os.path.basename(label_path))[0]
                == os.path.splitext(os.path.basename(image_path))[0])

    def postprocess(self, item: Dict) -> Dict:
        """A subclass's last word on an item (reference :131)."""
        return item

    # -- pipeline ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.label_paths)

    def _tail(self, img: Image.Image, params: TransformParams) -> Image.Image:
        """The random crop, then the flip (new PIL images: a cached one is
        never changed)."""
        spec = self.spec
        if "crop" in spec.preprocess:
            x, y = params.crop_pos
            img = img.crop((x, y, x + spec.crop_size, y + spec.crop_size))
        if params.flip:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    def _decode(self, index: int) -> Tuple:
        """Decode and resize (cacheable): label and instance planes NEAREST
        in their own mode, the photo BICUBIC in RGB."""
        label = Image.open(self.label_paths[index])
        orig_size = label.size  # get_params reads the original size
        label = resize_image(label, self.spec, Image.NEAREST, convert=False)
        image = resize_image(Image.open(self.image_paths[index]).convert("RGB"), self.spec,
                             Image.BICUBIC, convert=False)
        inst = None
        if not self.no_instance:
            inst = resize_image(Image.open(self.instance_paths[index]), self.spec,
                                Image.NEAREST, convert=False)
        return orig_size, label, image, inst

    def __getitem__(self, index: int) -> Dict:
        if self.cache is not None:
            entry = self.cache[index]
            if entry is None:
                entry = self.cache[index] = self._decode(index)
        else:
            entry = self._decode(index)
        orig_size, label, image, inst = entry
        params = get_params(self.spec, orig_size, self._rng)
        lab = np.asarray(self._tail(label, params), dtype=np.float32)
        if self.contain_dontcare_label:
            # reference spade_dataset.py:56-58: 'unknown' is input_nc
            lab = np.where(lab == 255.0, float(self.input_nc), lab)
        img = np.asarray(self._tail(image, params), dtype=np.float32) / 127.5 - 1.0
        item: Dict = {"label": lab, "image": np.ascontiguousarray(img.transpose(2, 0, 1)),
                      "path": self.image_paths[index]}
        if inst is not None:
            item["instance"] = np.asarray(self._tail(inst, params), dtype=np.int32)
        return self.postprocess(item)


class TemplateDataset(SPADEDataset):
    """The custom-dataset starting point (reference data/template_dataset.py):
    ``<dataroot>/<phase>_labels`` and ``<dataroot>/<phase>_images`` with the
    same file stems, and ``<phase>_instances`` where it exists."""

    def get_paths(self):
        root, phase = self.dataroot, self.phase
        labels = make_dataset(os.path.join(root, f"{phase}_labels"))
        images = make_dataset(os.path.join(root, f"{phase}_images"))
        inst_dir = os.path.join(root, f"{phase}_instances")
        instances = make_dataset(inst_dir) if os.path.isdir(inst_dir) else []
        return labels, images, instances
