"""Low-level neural-net ops: padding, activations, normalisation, init.

Tensors are NCHW (PyTorch's layout); the JAX package keeps NHWC.  The
numerics follow ``cat_tpu/ops/nn.py``: instance and batch statistics are
E[x²] - mean² in float32, and the result is cast back to the input dtype.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.core.config import NormConfig
from cat_tpu_torch.ops.spectral import SpectralConv2d
from cat_tpu_torch.parallel import collectives

# ---------------------------------------------------------------------------
# Padding
# ---------------------------------------------------------------------------

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def spatial_pad(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Pad H and W of an NCHW tensor (reference: nn.ReflectionPad2d et al.)."""
    if pad == 0:
        return x
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"padding [{mode}] is not implemented")
    return F.pad(x, (pad, pad, pad, pad), mode=_PAD_MODES[mode])


# ---------------------------------------------------------------------------
# Activations (reference: inception_modules.get_active_fn)
# ---------------------------------------------------------------------------


def activation(name: str, slope: float = 0.01) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("relu", "nn.ReLU"):
        return F.relu
    if name in ("relu6", "nn.ReLU6"):
        return F.relu6
    if name in ("leaky_relu", "nn.LeakyReLU"):
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if name == "tanh":
        return torch.tanh
    if name in ("none", "identity"):
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Initialisers (reference: models/networks.py:108-144 init_weights)
# ---------------------------------------------------------------------------


def _fans(w: torch.Tensor):
    # (out, in, kh, kw); init_weights hands transposed-conv weights over as
    # a transposed view, so fan_in is always the JAX kernel's in*kh*kw
    receptive = w[0, 0].numel() if w.dim() > 2 else 1
    return w.shape[1] * receptive, w.shape[0] * receptive


def conv_kernel_init(init_type: str = "normal", init_gain: float = 0.02):
    """In-place weight initialiser ``fn(weight, generator)``, matching the
    JAX package's ``conv_kernel_init`` distributions."""
    if init_type == "normal":
        return lambda w, g: w.normal_(0.0, init_gain, generator=g)
    if init_type == "xavier":
        # the JAX package's variance_scaling(2 g², fan_avg): 4 g²/(fan_in+fan_out)
        def xavier(w, g):
            fan_in, fan_out = _fans(w)
            return w.normal_(0.0, math.sqrt(4.0 * init_gain ** 2 / (fan_in + fan_out)),
                             generator=g)

        return xavier
    if init_type == "kaiming":
        return lambda w, g: w.normal_(0.0, math.sqrt(2.0 / _fans(w)[0]), generator=g)
    if init_type == "orthogonal":
        def orthogonal(w, g):
            q = torch.empty(w.shape, dtype=w.dtype, device=w.device)
            return w.copy_(nn.init.orthogonal_(q, init_gain, generator=g))

        return orthogonal
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def norm_scale_init(norm: NormConfig, init_gain: float = 0.02):
    """Batch-like norm scales start at N(1, gain); instance norms at 1."""
    if norm.is_batch_like:
        return lambda w, g: w.normal_(1.0, init_gain, generator=g)
    return lambda w, g: w.fill_(1.0)


@torch.no_grad()
def init_weights(module: nn.Module, init_type: str = "normal", init_gain: float = 0.02,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise every conv and norm under ``module`` in place: kernels by
    ``init_type``, biases to zero, norm scales by ``norm_scale_init``, a
    spectral conv's ``u`` at random."""
    kernel_init = conv_kernel_init(init_type, init_gain)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, SpectralConv2d)):
            if isinstance(m, SpectralConv2d):
                kernel_init(m.weight_orig, generator)
                m.reset_u(generator)
            else:
                kernel_init(m.weight.transpose(0, 1) if isinstance(m, nn.ConvTranspose2d)
                            else m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Norm2d) and m.weight is not None:
            norm_scale_init(m.cfg, init_gain)(m.weight, generator)
            m.bias.zero_()
    return module


# ---------------------------------------------------------------------------
# Transposed convolution (torch geometry)
# ---------------------------------------------------------------------------


class ConvTranspose2d(nn.ConvTranspose2d):
    """Stride-2 transposed conv with kernel 3, padding 1, output_padding 1:
    exact 2x upsampling, as the JAX package's ``ConvTranspose2d``.  The
    weight is torch's (in, out, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, output_padding=output_padding, bias=bias)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------


class Norm2d(nn.Module):
    """Instance / batch / sync-batch / no normalisation over NCHW, with the
    JAX package's numerics: float32 statistics var = E[x²] - mean² (not
    ``F.instance_norm``'s or ``F.batch_norm``'s formula), affine in float32,
    cast back to the input dtype.  Parameters are named ``weight``/``bias``
    and running statistics ``running_mean``/``running_var``, as in torch.

    Batch norm (``syncbatch`` and ``batch`` alike): with ``train`` the batch
    statistics over (N, H, W) normalise, with the biased variance, over the
    global batch when the ranks' collectives run (``batch_moments``);
    with tracked statistics they also move the running estimates,
    ``running = (1-m)·running + m·batch`` with the *unbiased* variance,
    unless ``update_stats`` is off (``frozen_stats``).  Without ``train``
    the running statistics normalise when they are tracked, else the batch
    statistics do.  A reference ``num_batches_tracked`` entry is ignored on
    load."""

    def __init__(self, cfg: NormConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.update_stats = True
        if cfg.has_scale:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if cfg.is_batch_like and cfg.track_running_stats:
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    @property
    def tracks_stats(self) -> bool:
        return self.cfg.is_batch_like and self.cfg.track_running_stats

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if cfg.kind == "none":
            return x
        if cfg.kind == "instance":
            return instance_norm(x, self.weight, self.bias, cfg.eps)
        xf = x.float()
        if train or not self.tracks_stats:
            mean, var, n = batch_moments(xf)
            if train:
                self.track(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + cfg.eps)[:, None, None]
        if self.weight is not None:
            y = y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def track(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Move the running statistics by one train-mode forward's batch
        ``mean`` and biased ``var`` over ``n`` values a channel, where they
        are tracked and ``frozen_stats`` does not hold them."""
        if self.tracks_stats and self.update_stats:
            m = self.cfg.momentum
            unbiased = var * (n / max(n - 1, 1))
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def batch_moments(xf: torch.Tensor):
    """Per-channel mean and biased variance E[x²] - mean² of a float32 NCHW
    batch over (N, H, W), and the count of values a channel.  When the
    ranks' collectives run, over the global batch: the sums of x and x² are
    all-reduced with their gradient (``parallel/collectives.py``), as the
    JAX package's batch norm over a sharded batch axis is synchronised;
    every rank holds an equal share, so the count is the rank's times the
    world size."""
    n = xf.shape[0] * xf.shape[2] * xf.shape[3]
    if not collectives.active():
        mean = xf.mean(dim=(0, 2, 3))
        return mean, xf.square().mean(dim=(0, 2, 3)) - mean.square(), n
    c = xf.shape[1]
    n *= collectives.world()[1]
    sums = collectives.all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                 xf.square().sum(dim=(0, 2, 3))]))
    mean = sums[:c] / n
    return mean, sums[c:] / n - mean.square(), n


@contextmanager
def frozen_stats(*nets: nn.Module):
    """Within the block, the batch norms under ``nets`` normalise with batch
    statistics in train mode but leave their running statistics as they
    are, and spectral convs iterate without writing ``u``: the JAX package's
    forwards that do not take ``mutable_stats``."""
    norms = [m for net in nets for m in net.modules() if hasattr(m, "update_stats")]
    saved = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(norms, saved):
            m.update_stats = s


def instance_norm_f32(xf: torch.Tensor, weight: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """Per-(sample, channel) normalisation of a float32 NCHW tensor with
    var = E[x²] - mean², then the optional affine in float32."""
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()[:, None, None] + bias.float()[:, None, None]
    return y


def instance_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """``instance_norm_f32`` on x upcast, cast back to x's dtype."""
    return instance_norm_f32(x.float(), weight, bias, eps).to(x.dtype)
