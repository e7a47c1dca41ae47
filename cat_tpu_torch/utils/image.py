"""Image conversion and file output (port of ``cat_tpu/utils/image.py``).

The port's images are CHW arrays or tensors in [-1, 1]; a converted image is
HWC uint8, as PIL writes it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def tensor2im(x) -> np.ndarray:
    """One [-1, 1] float CHW image (or NCHW with N == 1) -> uint8 HWC, with
    the JAX package's arithmetic; one channel is repeated to three."""
    arr = _numpy(x)
    if arr.ndim == 4:
        arr = arr[0]
    arr = (arr.transpose(1, 2, 0) + 1.0) / 2.0 * 255.0
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def save_image(image_u8: np.ndarray, path: str, create_dir: bool = True) -> None:
    if create_dir:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(image_u8).save(path)


# Cityscapes 35-class palette for label visualisation
# (reference utils/util.py:161-208 Colorize)
CITYSCAPES_PALETTE = np.array(
    [
        (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (111, 74, 0),
        (81, 0, 81), (128, 64, 128), (244, 35, 232), (250, 170, 160),
        (230, 150, 140), (70, 70, 70), (102, 102, 156), (190, 153, 153),
        (180, 165, 180), (150, 100, 100), (150, 120, 90), (153, 153, 153),
        (153, 153, 153), (250, 170, 30), (220, 220, 0), (107, 142, 35),
        (152, 251, 152), (70, 130, 180), (220, 20, 60), (255, 0, 0),
        (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90), (0, 0, 110),
        (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
    ],
    dtype=np.uint8,
)


def tensor2label(label_hw, n_labels: int = 35) -> np.ndarray:
    """Integer label map HW -> colourised uint8 HWC."""
    lab = _numpy(label_hw).astype(int)
    lab = np.clip(lab, 0, len(CITYSCAPES_PALETTE) - 1)
    return CITYSCAPES_PALETTE[lab]
