"""PatchGAN discriminator (port of ``cat_tpu/models/discriminators.py``;
``PixelDiscriminator`` is not ported yet).

State_dict keys follow the reference's ``nn.Sequential`` (``model.{i}``):
conv0 at 0, then (conv, norm, act) triples, the output conv last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cat_tpu_torch.core.config import NLayerDiscriminatorConfig
from cat_tpu_torch.ops.nn import Norm2d, activation, init_weights


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN: 4x4 convs, stride 2 (then 1), LeakyReLU(0.2)."""

    def __init__(self, cfg: NLayerDiscriminatorConfig, init_type: str = "normal",
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        use_bias = cfg.norm.kind in ("instance", "none")
        layers = [nn.Conv2d(cfg.input_nc, cfg.ndf, 4, 2, 1), nn.Identity()]
        cin = cfg.ndf
        for n in range(1, cfg.n_layers + 1):
            cout = cfg.ndf * min(2 ** n, 8)
            stride = 2 if n < cfg.n_layers else 1
            layers += [nn.Conv2d(cin, cout, 4, stride, 1, bias=use_bias),
                       Norm2d(cfg.norm, cout), nn.Identity()]
            cin = cout
        layers.append(nn.Conv2d(cin, 1, 4, 1, 1))
        self.model = nn.Sequential(*layers)
        init_weights(self, init_type, init_gain, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation(self.cfg.active_fn, slope=0.2)
        m = self.model
        h = act(m[0](x))
        for n in range(self.cfg.n_layers):
            h = act(m[3 * n + 3](m[3 * n + 2](h)))
        return m[-1](h)
