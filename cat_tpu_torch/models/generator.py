"""The ``inception_9blocks`` ResNet-style generator (port of
``cat_tpu/models/generator.py``).

State_dict keys are the reference CAT's:
  down_sampling.{1,4,7}  stem / down0 / down1 convs, {2,5,8} their norms
  features.{i}           inception blocks (res_ops / dw_ops / pw_bn)
  up_sampling.{3j}       transposed convs, {3j+1} their norms
  up_sampling.{3n+1}     the 7x7 output conv (n = len(us_channels))
so ``cat_tpu/utils/torch_import.py::import_inception_generator`` reads them.

Tap names: ``encode`` is the output of the downsampling trunk and
``block{i}`` the output of the i-th inception block.

Over a split height (``parallel/spatial.py``) the forward learns the
input's global height once and passes each layer its input's: the stem
and head pads, the stride-2 downsampling, the blocks' pads and the
transposed convs take their neighbours' rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from cat_tpu_torch.core.config import InceptionGeneratorConfig
from cat_tpu_torch.models.blocks import (InceptionBlock, block_norm_sites, conv_norm_act,
                                         kernel_act, norm_act)
from cat_tpu_torch.ops.nn import ConvTranspose2d, Norm2d, init_weights, spatial_pad
from cat_tpu_torch.parallel import spatial

# after the encoder and after features 2/5/8
DEFAULT_MAPPING_LAYERS = ("encode", "block2", "block5", "block8")


def fused_norm_sites(cfg: InceptionGeneratorConfig, packed: bool, size: int) -> list:
    """(layer, channels, height = width, the kernel's activation) of each
    norm call that ``fused_norms`` sends through the fused kernel in one
    forward of a ``size`` x ``size`` image, in order, from the config alone
    (``kernel_act`` decides): the trunk's, each block's
    (``block_norm_sites``), the upsampling's."""
    packed = packed and cfg.norm.kind in ("instance", "none")
    n_ds, n_us = len(cfg.ds_channels), len(cfg.us_channels)
    sites = [("trunk", c, size >> j, cfg.active_fn) for j, c in enumerate(cfg.ds_channels)]
    for b in cfg.blocks:
        sites += [("blocks", c, size >> (n_ds - 1), act)
                  for c, act in block_norm_sites(b, packed, cfg.active_fn)]
    sites += [("upsampling", c, size >> (n_us - 1 - j), cfg.active_fn)
              for j, c in enumerate(cfg.us_channels)]
    return [(layer, c, hw, kernel_act(cfg.norm, act, True)) for layer, c, hw, act in sites
            if kernel_act(cfg.norm, act, True) is not None]


class InceptionGenerator(nn.Module):
    def __init__(self, cfg: InceptionGeneratorConfig, init_type: str = "normal",
                 init_gain: float = 0.02, fused_norms: bool = False,
                 packed_blocks: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.fused_norms = fused_norms
        # conv bias is on iff the norm is instance/none (reference
        # inception_generator.py:30-34)
        use_bias = cfg.norm.kind in ("instance", "none")

        down = [nn.Identity(), nn.Conv2d(cfg.input_nc, cfg.ds_channels[0], 7, bias=use_bias),
                Norm2d(cfg.norm, cfg.ds_channels[0]), nn.Identity()]
        for cin, ch in zip(cfg.ds_channels[:-1], cfg.ds_channels[1:]):
            # zero-padded stride-2 3x3 conv
            down += [nn.Conv2d(cin, ch, 3, stride=2, padding=1, bias=use_bias),
                     Norm2d(cfg.norm, ch), nn.Identity()]
        self.down_sampling = nn.Sequential(*down)

        self.features = nn.ModuleList(
            InceptionBlock(b, norm=cfg.norm, padding_type=cfg.padding_type,
                           active_fn=cfg.active_fn, dropout_rate=cfg.dropout_rate,
                           use_bias=use_bias, fused_norms=fused_norms,
                           packed=packed_blocks)
            for b in cfg.blocks
        )

        up = []
        cin = cfg.bottleneck
        for ch in cfg.us_channels:
            up += [ConvTranspose2d(cin, ch, bias=use_bias), Norm2d(cfg.norm, ch), nn.Identity()]
            cin = ch
        up += [nn.Identity(), nn.Conv2d(cin, cfg.output_nc, 7, bias=True)]
        self.up_sampling = nn.Sequential(*up)
        init_weights(self, init_type, init_gain, generator)

    def forward(self, x: torch.Tensor, train: bool = False, taps: Sequence[str] = (),
                generator: Optional[torch.Generator] = None):
        """NCHW image -> NCHW image in [-1, 1]; with ``taps``, also a dict of
        the named intermediate activations.  ``train``: dropout on, and batch
        norms normalise with batch statistics (and move their running ones,
        unless ``ops/nn.py::frozen_stats`` holds them)."""
        cfg = self.cfg
        acts: Dict[str, torch.Tensor] = {}
        ds = self.down_sampling
        hh = spatial.global_height(x)  # None unless the height is split
        h = conv_norm_act(x, ds[1], ds[2], cfg.active_fn, self.fused_norms, 3,
                          cfg.padding_type, train, hh)
        for j in range(len(cfg.ds_channels) - 1):
            conv = ds[4 + 3 * j]
            h = conv_norm_act(h, conv, ds[5 + 3 * j], cfg.active_fn,
                              self.fused_norms, train=train, height=hh)
            hh = spatial.conv_height(hh, conv)
        if "encode" in taps:
            acts["encode"] = h

        for i, block in enumerate(self.features):
            h = block(h, train=train, generator=generator, height=hh)
            if f"block{i}" in taps:
                acts[f"block{i}"] = h

        us = self.up_sampling
        for j in range(len(cfg.us_channels)):
            h = norm_act(us[3 * j](h, hh), us[3 * j + 1], cfg.active_fn, self.fused_norms,
                         train)
            hh = spatial.conv_transpose_height(hh, us[3 * j])
        y = torch.tanh(us[-1](spatial_pad(h, 3, cfg.padding_type, hh)))
        if taps:
            return y, acts
        return y
