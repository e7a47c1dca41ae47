"""Conditional UNet for img2img diffusion-style models (port of
``cat_tpu/models/unet.py``), the family that shows the KA harness beyond
the inception GANs.

stem conv -> per level: res blocks (+ a stride-2 conv but at the last
level) -> two middle res blocks -> mirrored levels, each res block taking
the last skip concatenated after its input (``cat([h, skip])`` on the
channel axis), a nearest 2x resize and a conv between levels -> group norm,
SiLU and the head conv.  An optional sinusoidal timestep embedding
(``time_dim`` > 0) goes through two Dense layers and is added in every res
block.  Taps: ``down{i}``, ``mid``, ``up{i}``.

NCHW; the numerics are flax's: GroupNorm with eps 1e-6, ``min(groups, C)``
groups, statistics E[x²] - mean² in float32 (clipped at 0); every layer
computes in the promoted dtype of its input and parameters, as flax's
``promote_dtype`` does (a float32 timestep embedding makes the rest of a
bf16 forward float32, as in the JAX package).  Submodules carry the JAX
package's names (``down{i}_res{j}.conv1``, ``temb_dense1``, ...).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 3
    base: int = 64
    mults: Tuple[int, ...] = (1, 2, 4)
    res_blocks: int = 2
    time_dim: int = 0  # 0 disables timestep conditioning
    groups: int = 8

    @property
    def tap_widths(self) -> Dict[str, int]:
        widths = {}
        for i, m in enumerate(self.mults):
            widths[f"down{i}"] = self.base * m
            widths[f"up{i}"] = self.base * m
        widths["mid"] = self.base * self.mults[-1]
        return widths


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin, cos] of t times dim/2 frequencies 10000^(-i / (dim/2 - 1)), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                          device=t.device) / max(half - 1, 1))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _promoted(*ts: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
    dt = ts[0].dtype
    for t in ts[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return tuple(None if t is None else t.to(dt) for t in ts)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with zero SAME padding (odd kernels)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=(k - 1) // 2)

    def forward(self, x):
        x, w, b = _promoted(x, self.weight, self.bias)
        return F.conv2d(x, w, b, self.stride, self.padding)


class Dense(nn.Linear):
    def forward(self, x):
        x, w, b = _promoted(x, self.weight, self.bias)
        return F.linear(x, w, b)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (eps 1e-6) over NCHW with contiguous channel
    groups: float32 statistics, the affine in float32, the result in the
    promoted dtype of x and the parameters."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c, h, w = x.shape
        xf = x.float().reshape(n, self.groups, -1)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min(xf.square().mean(-1, keepdim=True) - mean.square(), 0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(n, c, h, w)
        y = y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(_promoted(x, self.weight)[0].dtype)


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, groups: int = 8, time_dim: int = 0):
        super().__init__()
        self.norm1 = GroupNorm(min(groups, cin), cin)
        self.conv1 = Conv(cin, features, 3)
        self.temb_proj = Dense(time_dim * 4, features) if time_dim > 0 else None
        self.norm2 = GroupNorm(min(groups, features), features)
        self.conv2 = Conv(features, features, 3)
        self.skip = Conv(cin, features, 1) if cin != features else None

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        c, td = cfg.base, cfg.time_dim
        if td > 0:
            self.temb_dense1 = Dense(td, td * 4)
            self.temb_dense2 = Dense(td * 4, td * 4)
        self.stem = Conv(cfg.in_channels, c, 3)
        skips, ch = [c], c
        for i, m in enumerate(cfg.mults):
            for j in range(cfg.res_blocks):
                self.add_module(f"down{i}_res{j}", ResBlock(ch, c * m, cfg.groups, td))
                ch = c * m
                skips.append(ch)
            if i != len(cfg.mults) - 1:
                self.add_module(f"down{i}_pool", Conv(ch, ch, 3, stride=2))
                skips.append(ch)
        for j in range(2):
            self.add_module(f"mid_res{j}", ResBlock(ch, c * cfg.mults[-1], cfg.groups, td))
            ch = c * cfg.mults[-1]
        for i in reversed(range(len(cfg.mults))):
            m = cfg.mults[i]
            for j in range(cfg.res_blocks + 1):
                self.add_module(f"up{i}_res{j}", ResBlock(ch + skips.pop(), c * m, cfg.groups, td))
                ch = c * m
            if i != 0:
                self.add_module(f"up{i}_conv", Conv(ch, ch, 3))
        self.head_norm = GroupNorm(min(cfg.groups, ch), ch)
        self.head = Conv(ch, cfg.out_channels, 3)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                taps: Sequence[str] = ()):
        cfg = self.cfg
        acts: Dict[str, torch.Tensor] = {}
        temb = None
        if cfg.time_dim > 0 and t is not None:
            temb = self.temb_dense1(timestep_embedding(t, cfg.time_dim))
            temb = self.temb_dense2(F.silu(temb))

        h = self.stem(x)
        skips = [h]
        for i in range(len(cfg.mults)):
            for j in range(cfg.res_blocks):
                h = getattr(self, f"down{i}_res{j}")(h, temb)
                skips.append(h)
            if f"down{i}" in taps:
                acts[f"down{i}"] = h
            if i != len(cfg.mults) - 1:
                h = getattr(self, f"down{i}_pool")(h)
                skips.append(h)
        h = self.mid_res1(self.mid_res0(h, temb), temb)
        if "mid" in taps:
            acts["mid"] = h
        for i in reversed(range(len(cfg.mults))):
            for j in range(cfg.res_blocks + 1):
                h = getattr(self, f"up{i}_res{j}")(torch.cat([h, skips.pop()], 1), temb)
            if f"up{i}" in taps:
                acts[f"up{i}"] = h
            if i != 0:
                h = getattr(self, f"up{i}_conv")(F.interpolate(h, scale_factor=2, mode="nearest"))
        y = self.head(F.silu(self.head_norm(h)))
        if taps:
            return y, acts
        return y
