"""Spectral normalisation of convolution kernels (port of
``cat_tpu/ops/spectral.py``).

Reference: torch.nn.utils.spectral_norm on the discriminator's convs
(models/modules/spade_architecture/normalization.py:17-50, the
``spectral*`` norm_D prefixes) and optionally on SPADE-block convs.

The JAX package's semantics, which are not ``torch.nn.utils.spectral_norm``'s:

  * every forward runs one power iteration on the (out, in·kh·kw) kernel
    matrix from the stored left singular vector ``u`` (train and eval);
  * the kernel is divided by σ = u'·W·v held constant: no gradient flows
    through σ;
  * ``u`` is written only by a train forward that may write state: the
    D step, never the G step's D forward (``ops/nn.py::frozen_stats``).

State_dict keys follow torch's spectral_norm (``weight_orig``, ``weight_u``,
``weight_v``, ``bias``), so a reference checkpoint's spectral convs load
strictly; ``weight_v`` is l2norm(Wᵀu) of the stored ``u`` (informational:
the forward derives v from ``u``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cat_tpu_torch.parallel import spatial

_EPS = 1e-12


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _EPS)


class SpectralConv2d(nn.Module):
    """Zero-padded conv with a spectrally normalised kernel.  ``update_stats``
    (cleared by ``frozen_stats``) lets a train forward write ``u``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.update_stats = True
        self.weight_orig = nn.Parameter(torch.empty(cout, cin // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("weight_u", _l2norm(torch.ones(cout)))  # init_weights draws it
        self.register_buffer("weight_v", torch.zeros(self.weight_orig[0].numel()))

    @torch.no_grad()
    def reset_u(self, generator=None) -> None:
        """A random unit ``u``, as the JAX package's init draws it."""
        u = torch.randn(self.weight_u.shape, generator=generator)
        self.weight_u.copy_(_l2norm(u).to(self.weight_u.device))

    def normalized_weight(self, train: bool = False) -> torch.Tensor:
        w = self.weight_orig
        with torch.no_grad():
            mat = w.detach().float().reshape(w.shape[0], -1)
            v = _l2norm(mat.t() @ self.weight_u)
            u = _l2norm(mat @ v)
            sigma = u @ (mat @ v)
            if train and self.update_stats:
                self.weight_u.copy_(u)
                self.weight_v.copy_(_l2norm(mat.t() @ u))
        return w / sigma.to(w.dtype)

    def forward(self, x: torch.Tensor, train: bool = False, h: Optional[int] = None,
                whole: bool = False) -> torch.Tensor:
        """Over a split height the halo conv (``spatial.conv2d_fn``; ``h``,
        ``whole`` as there); the power iteration reads the weights alone,
        which every rank holds alike, so ``u`` stays equal on every rank."""
        w = self.normalized_weight(train)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return spatial.conv2d_fn(x, w.to(x.dtype), bias, self.stride, self.padding, self.groups,
                                 h, whole)


@torch.no_grad()
def fold_spectral(net: nn.Module) -> nn.Module:
    """Replace, in place, every ``SpectralConv2d`` under ``net`` by an
    ``nn.Conv2d`` holding its eval-mode kernel (the one power iteration an
    eval forward runs from the stored ``u``): ``net``'s eval-mode function,
    with no power iteration left in it.  Returns ``net``."""
    for parent in list(net.modules()):
        for name, m in list(parent.named_children()):
            if isinstance(m, SpectralConv2d):
                w = m.normalized_weight()
                conv = nn.Conv2d(w.shape[1] * m.groups, w.shape[0], tuple(w.shape[2:]),
                                 stride=m.stride, padding=m.padding, groups=m.groups,
                                 bias=m.bias is not None, device=w.device, dtype=w.dtype)
                conv.weight.copy_(w)
                if m.bias is not None:
                    conv.bias.copy_(m.bias)
                setattr(parent, name, conv)
    return net
