"""PatchGAN discriminators (port of ``cat_tpu/models/discriminators.py``).

State_dict keys follow the reference's ``nn.Sequential``s: the NLayer D's
``model.{i}`` holds conv0 at 0, then (conv, norm, act) triples, the output
conv last; the pixel D's ``net.{i}`` holds conv0 at 0, conv1 at 2, its norm
at 3 and the output conv at 5.  Under a batch-like norm the convs that feed
a norm, and the pixel D's output conv, carry no bias, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cat_tpu_torch.core.config import NLayerDiscriminatorConfig, PixelDiscriminatorConfig
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``train``: batch norms normalise with batch statistics."""
        act = activation(self.cfg.active_fn, slope=0.2)
        m = self.model
        h = act(m[0](x))
        for n in range(self.cfg.n_layers):
            h = act(m[3 * n + 3](m[3 * n + 2](h), train))
        return m[-1](h)


class PixelDiscriminator(nn.Module):
    """1x1 PixelGAN discriminator."""

    def __init__(self, cfg: PixelDiscriminatorConfig, init_type: str = "normal",
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        use_bias = cfg.norm.kind in ("instance", "none")
        self.net = nn.Sequential(
            nn.Conv2d(cfg.input_nc, cfg.ndf, 1), nn.Identity(),
            nn.Conv2d(cfg.ndf, cfg.ndf * 2, 1, bias=use_bias), Norm2d(cfg.norm, cfg.ndf * 2),
            nn.Identity(), nn.Conv2d(cfg.ndf * 2, 1, 1, bias=use_bias),
        )
        init_weights(self, init_type, init_gain, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        act = activation(self.cfg.active_fn, slope=0.2)
        n = self.net
        h = act(n[0](x))
        h = act(n[3](n[2](h), train))
        return n[5](h)


def check_task_discriminator(cfg) -> None:
    """The JAX package's train tasks and distiller build an
    ``NLayerDiscriminator`` from whatever config they get, so a pixel
    config (which has no ``n_layers``) fails there at init.  The port's do
    the same work and refuse it with a clear message."""
    if isinstance(cfg, PixelDiscriminatorConfig):
        raise NotImplementedError(
            "--netD pixel: the JAX package's train and distill tasks build only the "
            "n_layers discriminator (a PixelDiscriminatorConfig has no n_layers), and so "
            "do the port's; PixelDiscriminator exists as a module only")
