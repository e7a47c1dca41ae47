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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from cat_tpu_torch.core.config import InceptionGeneratorConfig
from cat_tpu_torch.models.blocks import InceptionBlock, conv_norm_act
from cat_tpu_torch.ops.nn import ConvTranspose2d, Norm2d, activation, init_weights, spatial_pad

# after the encoder and after features 2/5/8
DEFAULT_MAPPING_LAYERS = ("encode", "block2", "block5", "block8")


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
        h = conv_norm_act(x, ds[1], ds[2], cfg.active_fn, self.fused_norms, 3,
                          cfg.padding_type, train)
        for j in range(len(cfg.ds_channels) - 1):
            h = conv_norm_act(h, ds[4 + 3 * j], ds[5 + 3 * j], cfg.active_fn,
                              self.fused_norms, train=train)
        if "encode" in taps:
            acts["encode"] = h

        for i, block in enumerate(self.features):
            h = block(h, train=train, generator=generator)
            if f"block{i}" in taps:
                acts[f"block{i}"] = h

        us = self.up_sampling
        act = activation(cfg.active_fn)
        for j in range(len(cfg.us_channels)):
            h = act(us[3 * j + 1](us[3 * j](h), train))
        y = torch.tanh(us[-1](spatial_pad(h, 3, cfg.padding_type)))
        if taps:
            return y, acts
        return y
