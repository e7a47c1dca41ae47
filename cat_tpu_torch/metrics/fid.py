"""Fréchet Inception Distance (port of ``cat_tpu/metrics/fid.py``).

Reference: metric/fid_score.py (activation harvesting 152-214, Fréchet
distance with singular-covariance retry 217-274, stats caching 277-350) and
the get_fid façade (metric/__init__.py:11-21).

The judge's features are computed on the judge's device in batches; the
Fréchet distance is host numpy/scipy (a one-off 2048 x 2048 matrix square
root), the same code as the JAX package's, so the same activations give the
same distance.  Generated images are quantised to uint8 before the judge,
as the reference does (metric/__init__.py:13-14).  Images are NCHW.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import linalg

from cat_tpu_torch.metrics.inception import InceptionV3FID


def tensor2im_batch(images) -> np.ndarray:
    """[-1, 1] float images -> uint8, any layout (reference
    utils/util.py:58-88)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    arr = (np.asarray(images) + 1.0) / 2.0 * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def get_activations(images_u8: np.ndarray, model: InceptionV3FID,
                    batch_size: int = 32) -> np.ndarray:
    """The judge's last output block for a uint8 NCHW image stack (values
    0..255), in float32, batch by batch on the judge's device.  When the
    stack is longer than a batch, its last batch is padded to the full
    batch size with zero images (and their features dropped), so every
    call has one shape, as in the JAX package."""
    device = next(model.parameters()).device
    n = images_u8.shape[0]
    outs = []
    for i in range(0, n, batch_size):
        chunk = images_u8[i: i + batch_size]
        pad = 0
        if chunk.shape[0] < batch_size and n > batch_size:
            pad = batch_size - chunk.shape[0]
            chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device).float() / 255.0
        feats = model(x)[-1].float().cpu().numpy()
        outs.append(feats[: batch_size - pad] if pad else feats)
    return np.concatenate(outs, axis=0)


def compute_statistics(act: np.ndarray):
    mu = np.mean(act, axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root without its warning for a singular
    product (the caller checks for non-finite values, as the JAX package's
    ``disp=False`` call does; SciPy 1.16 deprecates ``disp``)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return linalg.sqrtm(a)


def calculate_frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                               sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), with the reference's
    eps-offset retry for near-singular products and its imaginary-part
    check."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different widths: {mu1.shape} vs {mu2.shape}")

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print("fid calculation produces singular product; "
              f"adding {eps} to diagonal of cov estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            # reference semantics (fid_score.py:255-270): warn, keep the real
            # part, do not raise
            print("Warning: the fid may be incorrect!")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def get_fid(fakes, model: InceptionV3FID, real_stats: Dict[str, np.ndarray],
            batch_size: int = 32, moments_reduce: Optional[Callable] = None,
            distance: bool = True) -> Optional[float]:
    """FID of generated [-1, 1] NCHW images against cached real statistics
    ({'mu', 'sigma'}, as get_real_stat writes them).

    ``moments_reduce``: the merge over the ranks of an evaluation split
    between them (``parallel/multihost.py::reduce_moments``): this rank's
    float64 moments (n, Σa, Σaaᵀ) of its activations go in, the sums over
    the ranks come out, and mu and sigma follow from them (np.cov over the
    joined activations, ddof 1).  ``fakes`` may then be empty.  With
    ``distance`` off the rank joins the merge and returns None: the primary
    alone takes the matrix square root."""
    fakes = np.asarray(fakes) if not isinstance(fakes, torch.Tensor) else fakes
    n = fakes.shape[0]
    act = get_activations(tensor2im_batch(fakes), model, batch_size) if n else None
    if moments_reduce is None:
        mu, sigma = compute_statistics(act)
    else:
        a64 = None if act is None else act.astype(np.float64)
        n, s1, s2 = moments_reduce(n, None if a64 is None else a64.sum(axis=0),
                                   None if a64 is None else a64.T @ a64)
        mu = s1 / n
        sigma = (s2 - np.outer(s1, s1) / n) / (n - 1)
    if not distance:
        return None
    return calculate_frechet_distance(mu, sigma, real_stats["mu"], real_stats["sigma"])


def get_fid_direct(reals, fakes, model: InceptionV3FID, batch_size: int = 32,
                   robust: bool = False) -> float:
    """FID between two [-1, 1] image sets without cached statistics
    (reference get_fid_new, metric/__init__.py:75-113).  ``robust`` centres
    the activations on their coordinate-wise median, the reference's
    'median' FID."""
    act_r = get_activations(tensor2im_batch(reals), model, batch_size)
    act_f = get_activations(tensor2im_batch(fakes), model, batch_size)
    centre = np.median if robust else np.mean
    mu1, mu2 = centre(act_r, axis=0), centre(act_f, axis=0)
    s1, s2 = np.cov(act_r, rowvar=False), np.cov(act_f, rowvar=False)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def compute_real_stats(images_m11, model: InceptionV3FID,
                       batch_size: int = 32) -> Dict[str, np.ndarray]:
    """{'mu', 'sigma'} of a real-image set (reference get_real_stat.py:24-48)."""
    act = get_activations(tensor2im_batch(images_m11), model, batch_size)
    mu, sigma = compute_statistics(act)
    return {"mu": mu, "sigma": sigma}
