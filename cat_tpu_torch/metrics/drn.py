"""The DRN-D-105 segmentation judge of Cityscapes mIoU (port of
``cat_tpu/metrics/drn.py``).

Reference: metric/drn.py (dilated residual network, arch 'D', Bottleneck
blocks [1, 1, 3, 4, 23, 3, 1, 1], channels (16, 32, 64, 128, 256, 512,
512, 512)) and metric/mIoU_score.py:127-171 (DRNSeg: the backbone, a 1x1
segmentation head and a frozen bilinear x8 transposed convolution).

Submodules carry the names of ``drn-d-105_ms_cityscapes.pth``: ``base.0``
is layer0 (conv, bn), ``base.1``/``base.2``/``base.7``/``base.8`` are conv
stages of (conv, bn, relu) triples (``base.{l}.{3i}``, ``base.{l}.{3i+1}``),
``base.3``-``base.6`` are Bottleneck stages (``base.{l}.{b}.conv1`` ...
``bn3``, ``downsample.{0,1}``), ``seg`` is the head.  The checkpoint loads
strictly after its ``module.`` prefix and its ``up.weight`` (the fixed
bilinear filler, which the judge rebuilds) are dropped (``drnseg_layout``).

Inference only: batch norm always normalises with the stored statistics
(eps 1e-5), and the judge runs with TF32 off in its own scope, as the FID
judge does.  ``get_miou`` scores generated photos against trainId maps.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch import resolve_device
from cat_tpu_torch.metrics.inception import _no_tf32
from cat_tpu_torch.metrics.miou import fast_hist, mean_iou, normalize_for_drn

DRN_D_105_LAYERS = (1, 1, 3, 4, 23, 3, 1, 1)
DRN_CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)


class FrozenBN(nn.BatchNorm2d):
    """Batch norm on its running statistics, in train mode too."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _conv_stage(cin: int, cout: int, convs: int, stride: int = 1,
                dilation: int = 1) -> nn.Sequential:
    """(3x3 conv, bn, relu) x ``convs``; the first conv strides."""
    mods = []
    for i in range(convs):
        mods += [nn.Conv2d(cin if i == 0 else cout, cout, 3, stride=stride if i == 0 else 1,
                           padding=dilation, dilation=dilation, bias=False),
                 FrozenBN(cout), nn.ReLU()]
    return nn.Sequential(*mods)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False), FrozenBN(planes * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


def bilinear_up_kernel(k: int = 16) -> np.ndarray:
    """The reference's fixed bilinear filler (mIoU_score.py:114-123)."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    return w


class DRNSeg(nn.Module):
    """Arch-'D' dilated residual backbone (output stride 8), 1x1 head and
    the frozen bilinear x8 upsampling: a depthwise transposed convolution,
    kernel 16, stride 8, padding 4 (the JAX package's input-dilated conv
    with padding 11 is the same geometry).  NCHW in, logits out."""

    def __init__(self, classes: int = 19, layers: Sequence[int] = DRN_D_105_LAYERS,
                 channels: Sequence[int] = DRN_CHANNELS):
        super().__init__()
        self.classes, self.layers, self.channels = classes, tuple(layers), tuple(channels)
        ch = self.channels
        stages = [nn.Sequential(nn.Conv2d(3, ch[0], 7, padding=3, bias=False), FrozenBN(ch[0]),
                                nn.ReLU()),
                  _conv_stage(ch[0], ch[0], layers[0]),
                  _conv_stage(ch[0], ch[1], layers[1], stride=2)]
        cin = ch[1]
        for planes, blocks, stride, dil in ((ch[2], layers[2], 2, 1), (ch[3], layers[3], 2, 1),
                                            (ch[4], layers[4], 1, 2), (ch[5], layers[5], 1, 4)):
            stage = []
            for b in range(blocks):
                stage.append(Bottleneck(cin, planes, stride if b == 0 else 1, dil))
                cin = planes * 4
            stages.append(nn.Sequential(*stage))
        stages += [_conv_stage(cin, ch[6], layers[6], dilation=2),
                   _conv_stage(ch[6], ch[7], layers[7])]
        self.base = nn.Sequential(*stages)
        self.seg = nn.Conv2d(ch[7], classes, 1)
        up = torch.from_numpy(bilinear_up_kernel(16))
        self.register_buffer("up_kernel", up.expand(classes, 1, 16, 16).clone(), persistent=False)
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def forward(self, x: torch.Tensor, upsample: bool = True) -> torch.Tensor:
        with _no_tf32():
            logits = self.seg(self.base(x))
            if not upsample:
                return logits
            return F.conv_transpose2d(logits, self.up_kernel, stride=8, padding=4,
                                      groups=self.classes)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def drnseg_layout(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference DRNSeg state_dict in the judge's layout: the
    ``module.`` prefix of a DataParallel save stripped, the fixed ``up``
    filler dropped."""
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in state_dict.items()}
    return {k: v for k, v in sd.items() if not k.startswith("up.")}


def load_drnseg(path: str, classes: int = 19, device=None) -> DRNSeg:
    """The judge on ``device`` (CUDA unless the caller asks for the CPU):
    the reference's ``drn-d-105_ms_cityscapes.pth`` (or any ``.pth`` in its
    layout), loaded strictly, or a ``.msgpack`` + ``.json`` pair the JAX
    package's ``save_drnseg`` writes (its spec in the ``.json``)."""
    device = resolve_device(device)
    if path.endswith(".msgpack"):
        from cat_tpu_torch.utils.checkpoint import read_msgpack
        from cat_tpu_torch.utils.jax_import import drnseg_state_dict

        with open(path[: -len(".msgpack")] + ".json") as f:
            meta = json.load(f)
        model = DRNSeg(int(meta["classes"]), tuple(meta["layers"]), tuple(meta["channels"]))
        model.load_state_dict(drnseg_state_dict(read_msgpack(path), model.layers))
        return model.to(device)
    model = DRNSeg(classes)
    model.load_state_dict(drnseg_layout(torch.load(path, map_location="cpu",
                                                   weights_only=True)))
    return model.to(device)


def random_drnseg_state_dict(seed: int = 105, layers: Sequence[int] = DRN_D_105_LAYERS,
                             channels: Sequence[int] = DRN_CHANNELS,
                             classes: int = 19) -> Dict[str, torch.Tensor]:
    """A judge's weights in the reference checkpoint's key layout (its
    ``up.weight`` included), random from ``seed``: He fan-in convs, batch
    norm near identity with its residual branch's last scale small, so
    activations stay O(1) through ~105 layers.  The mIoU of such a judge
    exercises the plumbing, not image quality."""
    rs = np.random.RandomState(seed)
    model = DRNSeg(classes, layers, channels)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.tensor(0)
            continue
        if t.dim() == 4:
            arr = rs.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[1:])))
        elif name.endswith("running_var"):
            arr = 0.5 + rs.rand(*shape)
        elif name.endswith("weight"):  # batch-norm scale
            arr = (0.2 if ".bn3." in name else 1.0) + 0.1 * rs.randn(*shape)
        else:  # batch-norm bias and mean, the head's bias
            arr = 0.05 * rs.randn(*shape)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    sd["up.weight"] = model.up_kernel.clone()
    return sd


def write_random_drnseg(path: str, seed: int = 105, **spec) -> str:
    """Save ``random_drnseg_state_dict(seed, **spec)`` as a ``.pth`` that
    ``load_drnseg`` (and, for the full spec, the JAX package's) reads."""
    torch.save(random_drnseg_state_dict(seed, **spec), path)
    return path


# ---------------------------------------------------------------------------
# mIoU (reference mIoU_score.test:209-247)
# ---------------------------------------------------------------------------


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over NCHW: half-pixel
    centres, so ``align_corners=False``; jax antialiases only a dimension it
    shrinks, so an upscale is plain bilinear (``antialias=False``, the only
    case the judge meets) and a shrink uses torch's antialiased kernel."""
    hw = (int(hw[0]), int(hw[1]))
    shrink = hw[0] < x.shape[2] or hw[1] < x.shape[3]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=shrink)


def get_miou(fakes_m11, labels: Sequence[np.ndarray], model: DRNSeg, batch_size: int = 2,
             target_hw: Tuple[int, int] = (1024, 2048),
             num_classes: Optional[int] = None, hist_reduce: Optional[Callable] = None) -> float:
    """mIoU (percent, two decimals) of generated street photos against
    trainId label maps.

    ``fakes_m11``: [-1, 1] NCHW images (numpy or tensor); ``labels``: uint8
    (H, W) trainId maps at ``target_hw``.  On the judge's device, batch by
    batch: to [0, 1], a bilinear upscale to ``target_hw`` *before* the judge
    (reference SegList, mIoU_score.py:72-75), Cityscapes normalisation, the
    judge, a bilinear resize of the logits to ``target_hw``, argmax and the
    confusion matrix.  ``num_classes`` follows the judge by default.
    ``hist_reduce``: the merge of the confusion matrix over the ranks of an
    evaluation split between them (``parallel/multihost.py::reduce_hist``);
    ``fakes_m11`` may then be empty."""
    device = next(model.parameters()).device
    n_cls = model.classes if num_classes is None else num_classes
    hist = torch.zeros((n_cls, n_cls), dtype=torch.int64, device=device)
    fakes = torch.as_tensor(fakes_m11)
    for i in range(0, fakes.shape[0], batch_size):
        x01 = (fakes[i: i + batch_size].to(device).float() + 1.0) / 2.0
        x = normalize_for_drn(resize_bilinear(x01, target_hw))
        pred = resize_bilinear(model(x), target_hw).argmax(dim=1)
        for j in range(pred.shape[0]):
            label = torch.from_numpy(np.asarray(labels[i + j]).astype(np.int64)).to(device)
            hist += fast_hist(pred[j], label, n_cls)
    hist = hist.cpu().numpy()
    if hist_reduce is not None:
        hist = hist_reduce(hist)
    return round(mean_iou(hist), 2)
