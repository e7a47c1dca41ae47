"""Cityscapes mIoU scoring (port of ``cat_tpu/metrics/miou.py``).

Reference: metric/mIoU_score.py (fast_hist 174-177, 19-class mean IoU
209-247, the Cityscapes normalisation constants 72-82).  The DRN-D-105 judge
is ``metrics/drn.py``; this module is the judge-agnostic scoring.  The
histogram takes numpy arrays or tensors: on a tensor it is built where the
tensor lies (``torch.bincount`` in int64), count for count the numpy one.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

N_CLASSES = 19

# the normalisation the DRN judge was trained with (reference mIoU_score.py:72-82)
CITYSCAPES_MEAN = np.array([0.29010095242892997, 0.32808144844279574, 0.28696394422942517])
CITYSCAPES_STD = np.array([0.1829540508368939, 0.18656561047509476, 0.18447508988480435])


def fast_hist(pred, label, n: int = N_CLASSES):
    """n x n confusion matrix (rows: label, columns: prediction) of two
    flattened id maps; labels outside [0, n) (void, 255) are dropped.  int64,
    a tensor on the inputs' device when they are tensors."""
    if isinstance(pred, torch.Tensor):
        pred, label = pred.reshape(-1).long(), label.reshape(-1).long()
        k = (label >= 0) & (label < n)
        return torch.bincount(n * label[k] + pred[k], minlength=n ** 2).reshape(n, n)
    pred = np.asarray(pred).ravel()
    label = np.asarray(label).ravel()
    k = (label >= 0) & (label < n)
    return np.bincount(n * label[k].astype(int) + pred[k], minlength=n ** 2).reshape(n, n)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    hist = np.asarray(hist)
    denom = hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / denom


def mean_iou(hist: np.ndarray) -> float:
    """Mean IoU in percent over the classes present (nanmean, reference
    mIoU_score.py:236-246)."""
    return float(np.nanmean(per_class_iou(hist) * 100.0))


def median_iou(hist: np.ndarray) -> float:
    """Median per-class IoU in percent."""
    return float(np.nanmedian(per_class_iou(hist) * 100.0))


def accumulate_hist(pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                    n: int = N_CLASSES) -> np.ndarray:
    hist = np.zeros((n, n), dtype=np.int64)
    for pred, label in pairs:
        hist += np.asarray(fast_hist(pred, label, n))
    return hist


def normalize_for_drn(images01):
    """[0, 1] float NCHW images -> the judge's input (Cityscapes mean and
    standard deviation per channel)."""
    if isinstance(images01, torch.Tensor):
        mean = torch.tensor(CITYSCAPES_MEAN, dtype=images01.dtype, device=images01.device)
        std = torch.tensor(CITYSCAPES_STD, dtype=images01.dtype, device=images01.device)
        return (images01 - mean[:, None, None]) / std[:, None, None]
    return (images01 - CITYSCAPES_MEAN[:, None, None]) / CITYSCAPES_STD[:, None, None]
