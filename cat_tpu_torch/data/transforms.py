"""Image preprocessing: resize / crop / flip / normalise to [-1, 1] (port of
``cat_tpu/data/transforms.py``: the same PIL calls and numpy arithmetic, so
a given file, seed and spec give bit-identical pixels).

Reference: data/base_dataset.py:63-182 (shared random params so aligned A/B
pairs get identical crops/flips; preprocess modes resize_and_crop | crop |
scale_width | scale_width_and_crop | none).  An image comes out HWC, as in
the JAX package; ``chw`` lays it out for the port's NCHW batches.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from PIL import Image


@dataclass
class TransformParams:
    """Random params shared between the A and B sides of a pair."""

    crop_pos: Tuple[int, int] = (0, 0)
    flip: bool = False


@dataclass
class TransformSpec:
    preprocess: str = "resize_and_crop"
    load_size: int = 286
    crop_size: int = 256
    aspect_ratio: float = 1.0
    no_flip: bool = False
    method: int = Image.BICUBIC
    grayscale: bool = False


def get_params(spec: TransformSpec, size: Tuple[int, int],
               rng: Optional[random.Random] = None) -> TransformParams:
    rng = rng or random
    w, h = size
    new_w, new_h = w, h
    if spec.preprocess == "resize_and_crop":
        new_w = new_h = spec.load_size
    elif spec.preprocess == "scale_width_and_crop":
        new_w = spec.load_size
        new_h = spec.load_size * h // w
    x = rng.randint(0, max(0, new_w - spec.crop_size))
    y = rng.randint(0, max(0, new_h - spec.crop_size))
    flip = (not spec.no_flip) and rng.random() > 0.5
    return TransformParams(crop_pos=(x, y), flip=flip)


def _scale_width(img: Image.Image, target_size: int, crop_size: int, method) -> Image.Image:
    ow, oh = img.size
    if ow == target_size and oh >= crop_size:
        return img
    w = target_size
    h = int(max(target_size * oh / ow, crop_size))
    return img.resize((w, h), method)


def resize_image(img: Image.Image, spec: TransformSpec,
                 method=None, convert: bool = True) -> Image.Image:
    """Deterministic decode-time stage: colourspace + resize.

    Depends only on (path, spec), so its result is cacheable across epochs
    (--load_in_memory) — decode+resize is ~7ms/image of host time vs
    ~0.5ms for the random crop/flip/normalise tail, which matters when one
    host core must feed a >400 img/s training step.

    ``method`` overrides ``spec.method`` (label/instance planes resize
    NEAREST); ``convert=False`` keeps the source mode (raw-id label maps
    must not become RGB).
    """
    m = spec.method if method is None else method
    if convert:
        img = img.convert("L" if spec.grayscale else "RGB")
    if spec.preprocess == "resize_and_crop":
        img = img.resize((spec.load_size, spec.load_size), m)
    elif spec.preprocess in ("scale_width", "scale_width_and_crop"):
        img = _scale_width(img, spec.load_size, spec.crop_size, m)
    elif spec.preprocess == "scale_width_fixed":
        # cityscapes-style fixed aspect: width load_size, height by aspect
        img = img.resize(
            (spec.load_size, int(spec.load_size / spec.aspect_ratio)), m
        )
    return img


def finish_transform(
    img: Image.Image,
    spec: TransformSpec,
    params: Optional[TransformParams] = None,
) -> np.ndarray:
    """Per-epoch stage on a resized image: crop/flip -> [-1, 1] float32."""
    if "crop" in spec.preprocess:
        x, y = params.crop_pos if params else (0, 0)
        img = img.crop((x, y, x + spec.crop_size, y + spec.crop_size))
    if params is not None and params.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr * 2.0 - 1.0


def apply_transform(
    img: Image.Image,
    spec: TransformSpec,
    params: Optional[TransformParams] = None,
) -> np.ndarray:
    """PIL image -> float32 HWC array in [-1, 1]."""
    return finish_transform(resize_image(img, spec), spec, params)


def chw(arr: np.ndarray) -> np.ndarray:
    """An HWC image as a contiguous CHW array."""
    return np.ascontiguousarray(arr.transpose(2, 0, 1))
