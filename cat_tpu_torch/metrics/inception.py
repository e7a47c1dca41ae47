"""The FID variant of InceptionV3, the judge of FID and KID (port of
``cat_tpu/metrics/inception.py``).

The TensorFlow-FID network that the reference loads from
``pt_inception-2015-12-05.pth``: torchvision's InceptionV3 topology with the
FID quirks

  * the average pools of InceptionA, InceptionC and Mixed_7b's InceptionE
    leave the padding out of the divisor (``count_include_pad=False``),
  * Mixed_7c's InceptionE pools its pool branch with max, padding 1,
  * batch norm always uses the stored running statistics, eps 1e-3.

Submodules carry the names of that checkpoint (``Mixed_5b.branch1x1.conv.
weight``, ``.bn.running_mean``, ...), so it loads with a strict
``load_state_dict`` after its classifier heads are dropped (``load_inception``).

Input contract (the JAX package's): NCHW in [0, 1]; a bilinear resize to
299 x 299 with half-pixel centres, antialiased when it shrinks, as
``jax.image.resize`` is; then 2x - 1.  Block 3's features are the spatial
mean of Mixed_7c (pool3, 2048 wide).  The forward runs with TF32 off in its
own scope, so the features do not depend on the process's TF32 setting.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch import resolve_device


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions in float32, not TF32, inside the block."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _avg_pool_excl_pad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """conv (no bias) + batch norm on its running statistics (eps 1e-3) +
    relu."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, pad=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, pad=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, pad=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_excl_pad(x))  # FID variant
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), pad=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), pad=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_excl_pad(x))  # FID variant
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), pad=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), pad=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str):
        """``pool_kind``: "avg" (Mixed_7b, padding excluded) or "max"
        (Mixed_7c)."""
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, pad=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_kind == "max" else _avg_pool_excl_pad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """Bilinear resize to 299 x 299 with half-pixel centres, antialiased
    when it shrinks (``jax.image.resize(..., "bilinear")``)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                         antialias=True)


class InceptionV3FID(nn.Module):
    """Feature extractor; ``forward`` returns the features of
    ``output_blocks`` (0: 64 x 73 x 73 at a 299 input, 1: 192 x 35 x 35,
    2: 768 x 17 x 17, 3: the 2048 pool3 features), in block order."""

    def __init__(self, output_blocks: Sequence[int] = (3,)):
        super().__init__()
        self.output_blocks = tuple(sorted(output_blocks))
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, pad=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        with _no_tf32():
            return self._features(x)

    def _features(self, x):
        last = self.output_blocks[-1]
        outputs = {}
        x = 2.0 * resize_299(x) - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        outputs[0] = x = F.max_pool2d(x, 3, 2)
        if last >= 1:
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            outputs[1] = x = F.max_pool2d(x, 3, 2)
        if last >= 2:
            for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
                x = m(x)
            outputs[2] = x
        if last >= 3:
            for m in (self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
                x = m(x)
            outputs[3] = x.mean(dim=(2, 3))  # pool3
        return [outputs[i] for i in self.output_blocks]


def _judge_layout(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The checkpoint without its classifier heads (``fc``, ``AuxLogits``),
    which the features do not use; the JAX package's converter drops them
    too."""
    return {k: v for k, v in state_dict.items() if k.split(".")[0] not in ("fc", "AuxLogits")}


def load_inception(path: str, output_blocks: Sequence[int] = (3,),
                   device=None) -> InceptionV3FID:
    """The judge from a ``pt_inception-2015-12-05``-layout ``.pth``, loaded
    strictly, on ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    model = InceptionV3FID(output_blocks)
    model.load_state_dict(_judge_layout(state_dict))
    return model.to(device)


def random_judge_state_dict(seed: int = 233) -> Dict[str, torch.Tensor]:
    """A judge's weights in the checkpoint's key layout, random from
    ``seed``, scaled as ``tools/make_fixtures.py judges`` scales them (He
    fan-in for the convs, so activations stay O(1) through ~90 layers; batch
    norm near identity).  The values differ from that tool's; FID and KID
    of such a judge exercise the plumbing, not image quality."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, m in InceptionV3FID().named_modules():
        if not isinstance(m, BasicConv2d):
            continue
        shape = tuple(m.conv.weight.shape)  # OIHW
        fan_in = int(np.prod(shape[1:]))
        c = shape[0]

        def put(key, arr):
            sd[f"{name}.{key}"] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))

        put("conv.weight", rs.randn(*shape) * np.sqrt(2.0 / fan_in))
        put("bn.weight", 1.0 + 0.1 * rs.randn(c))
        put("bn.bias", 0.05 * rs.randn(c))
        put("bn.running_mean", 0.05 * rs.randn(c))
        put("bn.running_var", 0.5 + rs.rand(c))
    return sd


def write_random_judge(path: str, seed: int = 233) -> str:
    """Save ``random_judge_state_dict(seed)`` as a ``.pth`` that
    ``load_inception`` and the JAX package's ``load_inception`` both read."""
    torch.save(random_judge_state_dict(seed), path)
    return path

