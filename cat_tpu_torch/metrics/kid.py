"""Kernel Inception Distance (polynomial-kernel MMD): a copy of
``cat_tpu/metrics/kid.py``, which is plain numpy.

Reference: metric/kid_score.py — KID is the mean (± std) of the unbiased
MMD^2 estimator with kernel k(x,y) = (xᵀy/d + 1)^3 over ``n_subsets``
random subsets of ``subset_size`` activations (the shipped evaluate scripts
use 100 subsets of 100 — kid_score.py:141-143).

The reference also computes a U-statistic variance estimate per subset
(kid_score.py:205-283, the Sutherland et al. "Demystifying MMD GANs"
estimator) that is never reported by the shipped flows; it is available
here behind ``ret_var`` for full CLI parity (tools/kid_score.py --ret_var).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def polynomial_kernel(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
) -> np.ndarray:
    # float64 like the reference's sklearn polynomial_kernel (large
    # activations cubed overflow float32)
    x = np.asarray(x, np.float64)
    y = x if y is None else np.asarray(y, np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd(
    codes_g: np.ndarray,
    codes_r: np.ndarray,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
    ret_var: bool = False,
    var_at_m: Optional[int] = None,
):
    """Unbiased MMD^2 estimate between two activation sets.

    ``ret_var=True`` additionally returns the U-statistic variance estimate
    of the MMD^2 estimator at sample size ``var_at_m`` (default: the subset
    size m) — reference kid_score.py:205-283 / Sutherland et al. 2018,
    var = 4(M-2)/(M(M-1))·ζ₁ + 2/(M(M-1))·ζ₂ with plug-in ζ estimates.
    """
    k_xx = polynomial_kernel(codes_g, degree=degree, gamma=gamma, coef0=coef0)
    k_yy = polynomial_kernel(codes_r, degree=degree, gamma=gamma, coef0=coef0)
    k_xy = polynomial_kernel(codes_g, codes_r, degree=degree, gamma=gamma, coef0=coef0)
    m = k_xx.shape[0]
    d_x = np.diagonal(k_xx)
    d_y = np.diagonal(k_yy)
    rx = k_xx.sum(axis=1) - d_x  # off-diagonal row sums
    ry = k_yy.sum(axis=1) - d_y
    sx, sy = rx.sum(), ry.sum()
    sxy = k_xy.sum()
    mmd2 = (sx + sy) / (m * (m - 1)) - 2 * sxy / (m * m)
    if not ret_var:
        return float(mmd2)

    big_m = m if var_at_m is None else var_at_m
    cxy0 = k_xy.sum(axis=0)  # column sums
    cxy1 = k_xy.sum(axis=1)  # row sums
    k2x = (k_xx ** 2).sum() - (d_x ** 2).sum()  # Σ off-diag K_xx²
    k2y = (k_yy ** 2).sum() - (d_y ** 2).sum()
    k2xy = (k_xy ** 2).sum()
    dot_xx_xy = rx @ cxy1
    dot_yy_yx = ry @ cxy0
    m1, m2 = m - 1, m - 2
    zeta1 = (
        ((rx @ rx) - k2x + (ry @ ry) - k2y) / (m * m1 * m2)
        - (sx ** 2 + sy ** 2) / (m * m1) ** 2
        + ((cxy1 @ cxy1) + (cxy0 @ cxy0) - 2 * k2xy) / (m * m * m1)
        - 2 * sxy ** 2 / m ** 4
        - 2 * (dot_xx_xy + dot_yy_yx) / (m * m * m1)
        + 2 * (sx + sy) * sxy / (m ** 3 * m1)
    )
    zeta2 = (
        (k2x + k2y) / (m * m1)
        - (sx ** 2 + sy ** 2) / (m * m1) ** 2
        + 2 * k2xy / (m * m)
        - 2 * sxy ** 2 / m ** 4
        - 4 * (dot_xx_xy + dot_yy_yx) / (m * m * m1)
        + 4 * (sx + sy) * sxy / (m ** 3 * m1)
    )
    var = (4 * (big_m - 2) / (big_m * (big_m - 1)) * zeta1
           + 2 / (big_m * (big_m - 1)) * zeta2)
    return float(mmd2), float(var)


def kid_score(
    codes_g: np.ndarray,
    codes_r: np.ndarray,
    n_subsets: int = 100,
    subset_size: int = 100,
    seed: Optional[int] = None,
    ret_var: bool = False,
    **kernel_args,
):
    """(mean, std) of MMD^2 over random subsets — the reported KID.

    With ``ret_var=True`` returns (mean, std, var_estimates) where
    ``var_estimates`` are the per-subset U-statistic variance estimates at
    ``var_at_m = min(len(codes_g), len(codes_r))`` — mirroring the
    reference's polynomial_mmd_averages(ret_var=True) contract
    (kid_score.py:229-262)."""
    rng = np.random.RandomState(seed)
    subset_size = min(subset_size, len(codes_g), len(codes_r))
    var_at_m = min(len(codes_g), len(codes_r))
    mmds = np.zeros(n_subsets)
    var_ests = np.zeros(n_subsets)
    for i in range(n_subsets):
        g = codes_g[rng.choice(len(codes_g), subset_size, replace=False)]
        r = codes_r[rng.choice(len(codes_r), subset_size, replace=False)]
        if ret_var:
            mmds[i], var_ests[i] = polynomial_mmd(
                g, r, ret_var=True, var_at_m=var_at_m, **kernel_args)
        else:
            mmds[i] = polynomial_mmd(g, r, **kernel_args)
    if ret_var:
        return float(mmds.mean()), float(mmds.std()), var_ests
    return float(mmds.mean()), float(mmds.std())
