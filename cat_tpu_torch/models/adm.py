"""ADM's diffusion UNet (Dhariwal & Nichol 2021, openai/guided-diffusion
``guided_diffusion/unet.py::UNetModel``), image-conditioned as Palette
(Saharia et al. 2022): the source image concatenated to the noisy target
on the channel axis, ε predicted, no class embedding, dropout 0.

stem conv -> per level: ``num_res_blocks`` res blocks (+ attention where
the level's downsampling factor is in ``attention_resolutions``), then a
res block that average-pools inside (but at the last level) -> middle:
res, attention, res -> mirrored levels of ``num_res_blocks + 1`` res blocks
on ``cat([h, skip])``, attention as on the way down, a res block that
upsamples (nearest) inside at the end of each level but level 0 -> GroupNorm,
SiLU, conv to ``out_channels``.

The layers are ADM's, with ``resblock_updown`` and ``use_scale_shift_norm``:

* res block: ``h = conv3(SiLU(GN(x)))`` with the resample between the
  activation and the conv (and on the skip); ``(scale, shift) =
  Linear(SiLU(emb))``; ``h = conv3(SiLU(GN(h)·(1 + scale) + shift))``; the
  skip a 1x1 conv where the widths differ.  SiLU(emb) is the same in every
  block (each block's ``emb_layers.0``), so the net computes it once;
* GroupNorm32: 32 groups, eps 1e-5, statistics and affine in float32, the
  scale-shift and SiLU after it in float32 too, one rounding to the
  activation's dtype at the end (one kernel forward and one backward on the
  card: ``ops/group_norm.py``);
* attention: ``x + proj(attn(qkv(GN(x))))``, 1x1 qkv and proj, heads of
  ``num_head_channels``, q, k and v split per head in the legacy QKV layout
  (qkv read as (B·heads, 3·d, T)), scale 1/√d;
* timestep: ``[cos, sin]`` of t at frequencies exp(-ln(1e4)·i/half) in
  float32 from the integer t, then Linear(mc, 4mc), SiLU, Linear(4mc, 4mc).

Every conv, linear and attention computes in the parameters' dtype (bf16
under a bf16 ``GenericDistiller``); only the GroupNorm chain (statistics,
affine, scale-shift, SiLU), the softmax inside
``F.scaled_dot_product_attention`` and the sinusoid are float32.  The
GroupNorms' γ and β are named by ``float32_params()``, which
``GenericDistiller`` leaves float32 masters (as ADM's fp16 training keeps
its norms in float32), so their updates reach the forward unrounded.
Module names are guided-diffusion's (``input_blocks.1.0.
in_layers.2.weight``, ``middle_block.1.qkv.weight``, ...).  Taps are named
by block (``input_blocks.8``, ``middle_block``, ``output_blocks.14``): the
block's output.  Each attention block runs inside ``region("adm.attention")``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.ops.group_norm import group_norm_act
from cat_tpu_torch.utils.trace import region

GROUPS = 32
GN_EPS = 1e-5


@dataclass(frozen=True)
class ADMConfig:
    """guided-diffusion's ``create_model`` flags (the README's 256x256 by
    default, 6 input channels as Palette's)."""

    image_size: int = 256
    in_channels: int = 6
    model_channels: int = 256
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (32, 16, 8)
    channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_head_channels: int = 64

    def tap_widths(self) -> Dict[str, int]:
        """Each block's output channels, by tap name."""
        return {name: layers[-1][1 if layers[-1][0] == "attn" else 2]
                for name, layers in layout(self)}


def layout(cfg: ADMConfig, size: Optional[int] = None) -> List[Tuple[str, List[Tuple]]]:
    """Each block in forward order, as guided-diffusion builds them, run at
    ``size`` px (the config's ``image_size`` by default): ``(name,
    layers)``, a layer ``("stem", cin, cout, side)``, ``("res", cin, cout,
    side, resample)`` (the input's side; resample "", "down" or "up") or
    ``("attn", channels, side, heads)``."""
    size = size or cfg.image_size
    attention_ds = {cfg.image_size // r for r in cfg.attention_resolutions}
    mc, nrb = cfg.model_channels, cfg.num_res_blocks

    def attn(ch, ds):
        return [("attn", ch, size // ds, ch // cfg.num_head_channels)] if ds in attention_ds else []

    ch, ds = mc * cfg.channel_mult[0], 1
    blocks = [("input_blocks.0", [("stem", cfg.in_channels, ch, size)])]
    chans = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(nrb):
            blocks.append((f"input_blocks.{len(blocks)}",
                           [("res", ch, mc * mult, size // ds, "")] + attn(mc * mult, ds)))
            ch = mc * mult
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            blocks.append((f"input_blocks.{len(blocks)}", [("res", ch, ch, size // ds, "down")]))
            chans.append(ch)
            ds *= 2
    blocks.append(("middle_block", [("res", ch, ch, size // ds, ""),
                                    ("attn", ch, size // ds, ch // cfg.num_head_channels),
                                    ("res", ch, ch, size // ds, "")]))
    n_in = sum(1 for name, _ in blocks if name.startswith("input"))
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(nrb + 1):
            layers = [("res", ch + chans.pop(), mc * mult, size // ds, "")] + attn(mc * mult, ds)
            ch = mc * mult
            if level and i == nrb:
                layers.append(("res", ch, ch, size // ds, "up"))
                ds //= 2
            blocks.append((f"output_blocks.{len(blocks) - n_in - 1}", layers))
    return blocks


def attention_sites(cfg: ADMConfig, size: Optional[int] = None) -> List[Tuple[str, int, int, int]]:
    """Each attention block: (module, heads, tokens, head width)."""
    return [(f"{name}.{j}", layer[3], layer[2] ** 2, layer[1] // layer[3])
            for name, layers in layout(cfg, size)
            for j, layer in enumerate(layers) if layer[0] == "attn"]


def group_norm_sites(cfg: ADMConfig, size: Optional[int] = None) -> List[Tuple[str, int, int]]:
    """Each GroupNorm in forward order: (module, channels, side)."""
    out = []
    for name, layers in layout(cfg, size):
        for j, layer in enumerate(layers):
            if layer[0] == "res":
                _, cin, cout, side, resample = layer
                out_side = {"down": side // 2, "up": side * 2}.get(resample, side)
                out += [(f"{name}.{j}.in_layers.0", cin, side),
                        (f"{name}.{j}.out_layers.0", cout, out_side)]
            elif layer[0] == "attn":
                out.append((f"{name}.{j}.norm", layer[1], layer[2]))
    size = size or cfg.image_size
    return out + [("out.0", cfg.model_channels * cfg.channel_mult[0], size)]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """ADM's sinusoid: [cos, sin] of t times exp(-ln(max_period)·i/half),
    i < half, in float32 from the integer timesteps."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) with float32 statistics and affine, then optionally the
    timestep's scale-shift (``emb``: the (B, 2C) output of the block's
    ``emb_layers``, scale then shift) and SiLU, rounded once to the input's
    dtype (``ops/group_norm.py``: the hand-written kernels on a CUDA tensor)."""

    def __init__(self, channels: int):
        super().__init__(GROUPS, channels, eps=GN_EPS)

    def forward(self, x, emb: Optional[torch.Tensor] = None, silu: bool = False):
        return group_norm_act(x, self.num_groups, self.weight.float(), self.bias.float(),
                              self.eps, emb, silu)


def _resample(x: torch.Tensor, how: str) -> torch.Tensor:
    if how == "down":
        return F.avg_pool2d(x, 2)
    if how == "up":
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    return x


class ResBlock(nn.Module):
    """ADM's res block with the timestep's scale and shift after its second
    norm; ``resample`` ("down", "up" or "") inside, on both paths.  Its
    forward takes SiLU(emb), the output of its ``emb_layers.0``."""

    def __init__(self, cin: int, cout: int, emb_dim: int, resample: str = ""):
        super().__init__()
        self.resample = resample
        self.in_layers = nn.Sequential(GroupNorm32(cin), nn.SiLU(),
                                       nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, 2 * cout))
        # index 2 is ADM's Dropout (p = 0): the conv keeps its name out_layers.3
        self.out_layers = nn.Sequential(GroupNorm32(cout), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Identity() if cin == cout else nn.Conv2d(cin, cout, 1)

    def forward(self, x, silu_emb):
        h = self.in_layers[0](x, silu=True)
        h = self.in_layers[2](_resample(h, self.resample))
        x = _resample(x, self.resample)
        emb = self.emb_layers[1](silu_emb).to(h.dtype)
        h = self.out_layers[3](self.out_layers[0](h, emb, silu=True))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Self-attention over the pixels, ADM's legacy QKV layout."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, silu_emb=None):
        with region("adm.attention"):
            b, c, hh, ww = x.shape
            t = hh * ww
            xf = x.reshape(b, c, t)
            qkv = self.qkv(self.norm(xf))
            d = c // self.heads
            # (B·heads, 3d, T) per head [q; k; v], as tokens-major (B, heads, T, 3d)
            qkv = qkv.reshape(b, self.heads, 3 * d, t).transpose(2, 3).contiguous()
            q, k, v = qkv.split(d, dim=-1)
            a = F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(d))
            a = a.transpose(2, 3).reshape(b, c, t)
            return (xf + self.proj_out(a)).reshape(b, c, hh, ww)


class _Block(nn.ModuleList):
    """guided-diffusion's TimestepEmbedSequential: the res blocks take SiLU(emb)."""

    def forward(self, h, silu_emb):
        for layer in self:
            h = layer(h, silu_emb)
        return h


class ADMUNet(nn.Module):
    """ADM's UNetModel; ``forward(x, t, taps=())`` returns ε, or (ε, {tap:
    block output}) when ``taps`` names blocks."""

    def __init__(self, cfg: ADMConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb = 4 * mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(), nn.Linear(emb, emb))

        def build(layers):
            mods = []
            for layer in layers:
                if layer[0] == "stem":
                    mods.append(nn.Conv2d(layer[1], layer[2], 3, padding=1))
                elif layer[0] == "res":
                    mods.append(ResBlock(layer[1], layer[2], emb, layer[4]))
                else:
                    mods.append(AttentionBlock(layer[1], layer[3]))
            return _Block(mods)

        blocks = layout(cfg)
        self.input_blocks = nn.ModuleList(build(ls) for n, ls in blocks if n.startswith("input"))
        self.middle_block = build(dict(blocks)["middle_block"])
        self.output_blocks = nn.ModuleList(build(ls) for n, ls in blocks if n.startswith("output"))
        ch0 = mc * cfg.channel_mult[0]
        self.out = nn.Sequential(GroupNorm32(ch0), nn.SiLU(),
                                 nn.Conv2d(ch0, cfg.out_channels, 3, padding=1))

    def float32_params(self) -> List[str]:
        """The GroupNorms' γ and β: the parameters a mixed-precision step
        keeps float32."""
        return [f"{name}.{p}" for name, m in self.named_modules()
                if isinstance(m, nn.GroupNorm) for p in ("weight", "bias")]

    def forward(self, x: torch.Tensor, t: torch.Tensor, taps: Sequence[str] = ()):
        dt = self.out[2].weight.dtype
        silu_emb = F.silu(self.time_embed(timestep_embedding(t, self.cfg.model_channels)
                                          .to(dt)))
        want, acts = set(taps), {}

        def keep(name, h):
            if name in want:
                acts[name] = h
            return h

        hs = [keep("input_blocks.0", self.input_blocks[0][0](x.to(dt)))]
        for i, block in enumerate(self.input_blocks[1:], 1):
            hs.append(keep(f"input_blocks.{i}", block(hs[-1], silu_emb)))
        h = keep("middle_block", self.middle_block(hs[-1], silu_emb))
        for i, block in enumerate(self.output_blocks):
            h = keep(f"output_blocks.{i}", block(torch.cat([h, hs.pop()], 1), silu_emb))
        eps = self.out[2](self.out[0](h, silu=True))
        if not taps:
            return eps
        return eps, {k: acts[k] for k in taps}
