"""The VGG19 perceptual loss of SPADE training (port of
``cat_tpu/models/vgg.py``).

Reference: models/modules/loss.py:151-203: the relu1_1 ... relu5_1 slices
of torchvision's VGG19, L1 weighted 1/32, 1/16, 1/8, 1/4, 1.  The reference
feeds [-1, 1] images in without ImageNet normalisation; so does this.

``VGG19Features.features`` is torchvision's ``vgg19().features`` (its
``features.{i}.weight``/``.bias`` keys), so ``vgg19.pth`` loads strictly
after its classifier is dropped (``load_vgg19``); the forward stops at
relu5_1.  The judge trains nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch import resolve_device

# torchvision vgg19 "E" configuration: conv widths, "M" a 2x2 max pool
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
        512, 512, 512, 512, "M")
_SLICE_ENDS = (1, 6, 11, 20, 29)  # the relu of conv 0, 5, 10, 19, 28: relu1_1 ... relu5_1

VGG_LOSS_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VGG19Features(nn.Module):
    """``forward`` returns [relu1_1, relu2_1, relu3_1, relu4_1, relu5_1],
    computed in the input's dtype (the float32 weights cast to it)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i, m in enumerate(self.features[: _SLICE_ENDS[-1] + 1]):
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(x.dtype), m.bias.to(x.dtype), padding=1)
            else:
                x = m(x)
            if i in _SLICE_ENDS:
                outs.append(x)
        return outs


def vgg19_layout(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision's ``vgg19`` (or ``vgg19().features``) state_dict as the
    module's: ``features.*`` kept, the classifier dropped."""
    if not any(k.startswith("features.") for k in state_dict):
        state_dict = {f"features.{k}": v for k, v in state_dict.items()}
    return {k: v for k, v in state_dict.items() if k.startswith("features.")}


def load_vgg19(path: str, device=None) -> VGG19Features:
    """The loss network from a torchvision ``vgg19.pth``, loaded strictly,
    on ``device`` (CUDA unless the caller asks for the CPU)."""
    model = VGG19Features()
    model.load_state_dict(vgg19_layout(torch.load(path, map_location="cpu", weights_only=True)))
    return model.to(resolve_device(device))


def random_vgg19_state_dict(seed: int = 19) -> Dict[str, torch.Tensor]:
    """VGG19 weights in torchvision's ``features.{i}`` layout, random from
    ``seed`` (He fan-in, small biases): the loss's plumbing, not its
    meaning."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, t in VGG19Features().state_dict().items():
        shape = tuple(t.shape)
        arr = (rs.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[1:]))) if t.dim() == 4
               else 0.01 * rs.randn(*shape))
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return sd


def vgg_loss(model: VGG19Features, x: torch.Tensor, y: torch.Tensor,
             compute_dtype: Optional[str] = None) -> torch.Tensor:
    """Weighted L1 over the five slices, the target ``y`` held constant
    (the reference detaches it, loss.py:196-202).  ``compute_dtype``
    ("bfloat16") runs the conv sweep in that dtype; each slice's L1 is taken
    in float32 either way."""
    cdt = _DTYPES[compute_dtype or "float32"]
    fx = model(x.to(cdt))
    with torch.no_grad():
        fy = model(y.detach().to(cdt))
    total = torch.zeros((), device=x.device)
    for w, a, b in zip(VGG_LOSS_WEIGHTS, fx, fy):
        total = total + w * (a.float() - b.float()).abs().mean()
    return total
