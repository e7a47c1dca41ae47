"""DeepLab v2 (dilated ResNet + ASPP) and the MSC multi-scale wrapper (port of
``cat_tpu/metrics/deeplabv2.py``).

Reference: metric/deeplabv2.py, exported by the reference's metric package
and read by none of its shipped configs.  Architecture: output stride 8;
ch = [64·2^p for p in 0..5]; layer1 = 7x7/2 stem + ceil-mode 3x3/2 max pool;
layer2..5 = bottleneck res-layers (expansion 4) at strides (1, 2, 1, 1)
and dilations (1, 1, 2, 4); head = ASPP (parallel 3x3 atrous convs with
bias, summed).  MSC runs the base at scale 1 and at ``scales`` (bilinear,
``align_corners=False``, the given factor used for the source coordinates),
resizes the pyramid's logits bilinearly to the full-scale logits' size and
takes the element-wise max; in train mode it returns ``[logits,
*pyramid, max]``.

NCHW, the reference's module names (``layer1.conv1.conv.weight``,
``layer2.block1.reduce.bn.running_mean``, ``aspp.c0.weight``, and
``base.`` before them under MSC), so a reference state_dict loads directly
(``load_deeplabv2`` also takes an MSC checkpoint into a bare base).  The
batch norms are frozen: they normalise with their stored statistics in
train mode too, as the JAX package's (``metrics/drn.py::FrozenBN``).
Inference only.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.metrics.drn import FrozenBN

BOTTLENECK_EXPANSION = 4


class CBR(nn.Module):
    """Bias-free conv + frozen batch norm + optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, dilation, bias=False)
        self.bn = FrozenBN(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dilation: int, downsample: bool):
        super().__init__()
        mid = cout // BOTTLENECK_EXPANSION
        self.reduce = CBR(cin, mid, 1, stride)
        self.conv3x3 = CBR(mid, mid, 3, 1, dilation, dilation)
        self.increase = CBR(mid, cout, 1, relu=False)
        self.shortcut = CBR(cin, cout, 1, stride, relu=False) if downsample else None

    def forward(self, x):
        h = self.increase(self.conv3x3(self.reduce(x)))
        return F.relu(h + (x if self.shortcut is None else self.shortcut(x)))


class Stem(nn.Module):
    def __init__(self, cout: int):
        super().__init__()
        self.conv1 = CBR(3, cout, 7, 2, 3)

    def forward(self, x):
        return F.max_pool2d(self.conv1(x), 3, 2, 1, ceil_mode=True)


class ResLayer(nn.Sequential):
    def __init__(self, n_layers: int, cin: int, cout: int, stride: int, dilation: int):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"block{i + 1}", Bottleneck(cin if i == 0 else cout, cout,
                                                        stride if i == 0 else 1, dilation,
                                                        i == 0))


class ASPP(nn.Module):
    def __init__(self, cin: int, n_classes: int, rates: Sequence[int]):
        super().__init__()
        for i, rate in enumerate(rates):
            conv = nn.Conv2d(cin, n_classes, 3, 1, rate, rate, bias=True)
            nn.init.normal_(conv.weight, 0.0, 0.01)
            nn.init.zeros_(conv.bias)
            self.add_module(f"c{i}", conv)

    def forward(self, x):
        return sum(conv(x) for conv in self.children())


class DeepLabV2(nn.Module):
    """Dilated ResNet + ASPP, output stride 8."""

    def __init__(self, n_classes: int, n_blocks: Sequence[int], atrous_rates: Sequence[int]):
        super().__init__()
        ch = [64 * 2 ** p for p in range(6)]
        self.layer1 = Stem(ch[0])
        self.layer2 = ResLayer(n_blocks[0], ch[0], ch[2], 1, 1)
        self.layer3 = ResLayer(n_blocks[1], ch[2], ch[3], 2, 1)
        self.layer4 = ResLayer(n_blocks[2], ch[3], ch[4], 1, 2)
        self.layer5 = ResLayer(n_blocks[3], ch[4], ch[5], 1, 4)
        self.aspp = ASPP(ch[5], n_classes, atrous_rates)

    def forward(self, x):
        for m in (self.layer1, self.layer2, self.layer3, self.layer4, self.layer5, self.aspp):
            x = m(x)
        return x


class MSC(nn.Module):
    """Max-fuse the base's logits with those of the input rescaled by each
    of ``scales``, resized to the full-scale logits' grid."""

    def __init__(self, base: DeepLabV2, scales: Tuple[float, ...] = (0.5, 0.75)):
        super().__init__()
        self.base = base
        self.scales = scales

    def forward(self, x) -> Union[torch.Tensor, List[torch.Tensor]]:
        logits = self.base(x)
        size = logits.shape[2:]
        pyramid = [self.base(F.interpolate(x, scale_factor=p, mode="bilinear",
                                           align_corners=False, recompute_scale_factor=False))
                   for p in self.scales]
        logits_all = [logits] + [F.interpolate(t, size=size, mode="bilinear",
                                               align_corners=False) for t in pyramid]
        logits_max = torch.stack(logits_all).amax(0)
        if self.training:
            return [logits] + pyramid + [logits_max]
        return logits_max


def load_deeplabv2(model: DeepLabV2, state_dict: Dict[str, torch.Tensor]) -> DeepLabV2:
    """Load a reference state_dict into a bare base, its ``base.`` prefix
    (an MSC checkpoint) dropped where present."""
    model.load_state_dict({k[5:] if k.startswith("base.") else k: v
                           for k, v in state_dict.items()})
    return model
