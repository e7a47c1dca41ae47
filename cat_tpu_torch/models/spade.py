"""The SPADE (GauGAN) generator and its multiscale discriminator (port of
``cat_tpu/models/spade.py``).

Reference: models/modules/inception_modules.py:280-769 (ConvSyncBNReLU,
SPADEInvertedResidualChannels, InceptionSPADE),
inception_architecture/inception_spade_generator.py and
models/modules/discriminators.py:129-226 (the multiscale D).

Structure, as in the JAX package:
  * a block's first branch norms are affine; the depthwise middle norm is
    affine-free (inception_modules.py:472-474);
  * the γ/β branches of a SPADE norm always use affine sync batch norm +
    ReLU, whatever the block's norm (inception_modules.py:598-600);
  * the segmap is nearest-resized (floor convention) to the features' size
    at every SPADE norm; between blocks the features are upsampled 2x
    nearest;
  * conv_img is LeakyReLU(0.2), a 3x3 conv and tanh.

State_dict keys are the reference's (``tests/fixtures/torch_spade_fixture.npz``
loads strictly): ``fc``, ``fc_norm``, ``conv_img``; per block
``res_ops.{j}.0.{conv,norm}`` / ``res_ops.{j}.1.conv``,
``dw_ops.{j}.{0,1}.{conv,norm}`` / ``dw_ops.{j}.2.conv``, ``shortcut.0``
(norm) / ``shortcut.1.conv``, and under ``spade.``: ``param_free_norm``,
``res_ops.{j}.0.{conv,norm}`` / ``res_ops.{j}.1``, ``dw_ops.{j}.{0,1}.*`` /
``dw_ops.{j}.2``, where ``j`` counts the branches that exist.

``packed`` (the default, ``--packed_blocks``) evaluates a block's branches,
and its SPADE norm's, as kernel-size-homogeneous packed convolutions
(``_packed_branches``, the JAX package's ``_packed_branches``): the same
function of the same parameters and buffers, whose state_dict does not
change, so checkpoints, the shrink and the transfer do not depend on the
layout.  ``syncbatch`` and ``batch`` alike take the global batch's
statistics when the ranks' collectives run (``ops/nn.py::batch_moments``).

Over a split height (``parallel/spatial.py``) every network computes its
rank's rows: the generator takes the semantics whole (every rank holds
the label maps; each conv over them cuts its rows and halo from them) and
the activations split, their global heights from the latent's (the
config's) through each 2x resize; its convs, packed branches and
upsampling fetch their halo rows; the discriminator learns its input's
global height once and follows it through its 4x4 convs (padding 2) and
average pools.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.core.config import NormConfig
from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig, SPADEBlockConfig,
                                             SPADEGeneratorConfig, SPADELayerConfig)
from cat_tpu_torch.models.blocks import center_pad_kernel
from cat_tpu_torch.ops.nn import Norm2d, activation, batch_moments, init_weights
from cat_tpu_torch.ops.spectral import SpectralConv2d
from cat_tpu_torch.parallel import spatial
from cat_tpu_torch.parallel.spatial import nearest_resize_plain as nearest_resize


def _norm_cfg(kind: str, affine: bool, momentum: float = 0.1, eps: float = 1e-5) -> NormConfig:
    return NormConfig(kind=kind, affine=affine, track_running_stats=kind in ("batch", "syncbatch"),
                      momentum=momentum, eps=eps)


def _conv(cin: int, cout: int, k: int, groups: int = 1, bias: bool = True,
          spectral: bool = False) -> nn.Module:
    pad = (k - 1) // 2
    if spectral:
        return SpectralConv2d(cin, cout, k, padding=pad, groups=groups, bias=bias)
    return nn.Conv2d(cin, cout, k, padding=pad, groups=groups, bias=bias)


def _apply(conv: nn.Module, x: torch.Tensor, train: bool, h: Optional[int] = None,
           whole: bool = False) -> torch.Tensor:
    """``conv(x)``, over a split height through the halo conv (``h``: x's
    global height; ``whole``: x held at full height by every rank)."""
    if isinstance(conv, SpectralConv2d):
        return conv(x, train, h, whole)
    return spatial.conv2d(conv, x, h, whole)


class ConvNormActZ(nn.Module):
    """Zero-padded conv -> norm -> activation (reference ConvSyncBNReLU)."""

    def __init__(self, cin: int, cout: int, k: int, norm: NormConfig, act: str,
                 groups: int = 1, spectral: bool = False):
        super().__init__()
        self.conv = _conv(cin, cout, k, groups, spectral=spectral)
        self.norm = Norm2d(norm, cout)
        self.act = act

    def forward(self, x, train: bool = False, h: Optional[int] = None, whole: bool = False):
        return activation(self.act)(self.norm(_apply(self.conv, x, train, h, whole), train))


class PlainConv(nn.Module):
    """Zero-padded conv, spectrally normalised where asked (reference Conv)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True, spectral: bool = False):
        super().__init__()
        self.conv = _conv(cin, cout, k, bias=bias, spectral=spectral)

    def forward(self, x, train: bool = False, h: Optional[int] = None):
        return _apply(self.conv, x, train, h)


# ---------------------------------------------------------------------------
# the packed layout
# ---------------------------------------------------------------------------


def _kernel(conv: nn.Module, dtype: torch.dtype, train: bool):
    """(kernel, bias) of a branch conv in ``dtype``: a spectral conv's
    normalised kernel, whose power iteration writes ``u`` as its forward
    would."""
    w = conv.normalized_weight(train) if isinstance(conv, SpectralConv2d) else conv.weight
    return w.to(dtype), None if conv.bias is None else conv.bias.to(dtype)


def _packed_norm_act(y: torch.Tensor, norms: Sequence[Norm2d], train: bool,
                     act: str) -> torch.Tensor:
    """``Norm2d``'s batch-norm numerics over branches concatenated on the
    channel axis (statistics are per channel, so each branch's are those of
    its own forward), each branch's running statistics moved by its slice;
    the activation in float32 before the cast back, as the JAX packer."""
    yf = y.float()
    widths = [n.running_mean.numel() for n in norms]
    if train:
        mean, var, n = batch_moments(yf)  # over the global batch, as Norm2d's
        for norm, m, v in zip(norms, mean.split(widths), var.split(widths)):
            norm.track(m, v, n)
    else:
        mean = torch.cat([n.running_mean for n in norms])
        var = torch.cat([n.running_var for n in norms])
    yf = (yf - mean[:, None, None]) * torch.rsqrt(var + norms[0].cfg.eps)[:, None, None]
    if norms[0].weight is not None:
        yf = (yf * torch.cat([n.weight for n in norms]).float()[:, None, None]
              + torch.cat([n.bias for n in norms]).float()[:, None, None])
    return activation(act)(yf).to(y.dtype)


def _packed_branches(x: torch.Tensor, res_ops: nn.ModuleList, dw_ops: nn.ModuleList,
                     res_k: Sequence[int], dw_k: Sequence[int], act: str,
                     train: bool, h: Optional[int] = None, whole: bool = False) -> torch.Tensor:
    """The sum of a stage set's branches (``res_ops``/``dw_ops`` as the
    unpacked forward runs them, with kernel sizes ``res_k``/``dw_k``), packed
    as ``cat_tpu/models/spade.py::_packed_branches`` packs them:

      IN:  one conv per kernel-size group over the shared input (the
           depthwise branches' 1x1 convs join the k = 1 group), one packed
           norm + act per group;
      MID: one depthwise conv over every depthwise channel, the kernels
           centre-padded to the largest k, one packed norm + act;
      OUT: one conv per kernel-size group: inputs and kernels concatenated
           on the input axis give the group's branch sum; the biases are
           summed once, at the end.

    Zero SAME padding throughout, so same-k kernels concatenate with no
    padding inflation.  Every conv is ``spatial.conv2d_fn`` (``h``: x's
    global height; ``whole``: x, the IN convs' input, held whole)."""
    dt = x.dtype
    groups: Dict[int, list] = {}
    for k, op in zip(res_k, res_ops):
        groups.setdefault(k, []).append(op[0])
    for op in dw_ops:
        groups.setdefault(1, []).append(op[0])
    mids: Dict[nn.Module, torch.Tensor] = {}
    for k in sorted(groups):
        units = groups[k]
        ws, bs = zip(*(_kernel(u.conv, dt, train) for u in units))
        y = spatial.conv2d_fn(x, torch.cat(ws), torch.cat(bs), padding=(k - 1) // 2, h=h,
                              whole=whole)
        y = _packed_norm_act(y, [u.norm for u in units], train, act)
        for u, part in zip(units, y.split([w.shape[0] for w in ws], 1)):
            mids[u] = part

    outs: Dict[int, list] = {}
    for k, op in zip(res_k, res_ops):
        outs.setdefault(k, []).append((mids[op[0]], op[1]))
    if dw_ops:
        g = torch.cat([mids[op[0]] for op in dw_ops], 1)
        kmax = max(dw_k)
        units = [op[1] for op in dw_ops]
        ws, bs = zip(*(_kernel(u.conv, dt, train) for u in units))
        g = spatial.conv2d_fn(g, torch.cat([center_pad_kernel(w, kmax) for w in ws]),
                              torch.cat(bs), padding=(kmax - 1) // 2, groups=g.shape[1], h=h)
        g = _packed_norm_act(g, [u.norm for u in units], train, act)
        for op, part in zip(dw_ops, g.split([w.shape[0] for w in ws], 1)):
            outs.setdefault(1, []).append((part, op[2]))

    total, bias = None, None
    for k in sorted(outs):
        parts, convs = zip(*outs[k])
        kbs = [_kernel(c.conv if isinstance(c, PlainConv) else c, dt, train) for c in convs]
        y = spatial.conv2d_fn(parts[0] if len(parts) == 1 else torch.cat(parts, 1),
                              torch.cat([w for w, _ in kbs], 1), padding=(k - 1) // 2, h=h)
        total = y if total is None else total + y
        for _, b in kbs:
            bias = b if bias is None else bias + b
    return total + bias[:, None, None]


class InceptionSPADENorm(nn.Module):
    """out = param_free_norm(x) · (1 + γ(seg)) + β(seg); γ and β from a
    multi-branch net over the nearest-resized segmap.  ``seg`` is whole on
    every rank, x split where the height is (global height ``h``)."""

    def __init__(self, cfg: SPADELayerConfig, packed: bool = True):
        super().__init__()
        self.cfg, self.packed = cfg, packed
        self.param_free_norm = Norm2d(_norm_cfg(cfg.param_free_norm, affine=False), cfg.norm_nc)
        branch_norm = _norm_cfg("syncbatch", affine=True)
        out2, cin = 2 * cfg.norm_nc, cfg.label_nc
        self.res_ops = nn.ModuleList(
            nn.Sequential(ConvNormActZ(cin, mid, k, branch_norm, "relu"), _conv(mid, out2, k))
            for _, mid, k in cfg.active_res)
        self.dw_ops = nn.ModuleList(
            nn.Sequential(ConvNormActZ(cin, mid, 1, branch_norm, "relu"),
                          ConvNormActZ(mid, mid, k, branch_norm, "relu", groups=mid),
                          _conv(mid, out2, 1))
            for _, mid, k in cfg.active_dw)

    def forward(self, x, seg, train: bool = False, h: Optional[int] = None):
        normalized = self.param_free_norm(x, train)
        if self.cfg.is_empty:
            return normalized
        h = x.shape[2] if h is None else h
        seg = nearest_resize(seg, h, x.shape[3])
        cfg = self.cfg
        if self.packed:
            total = _packed_branches(seg, self.res_ops, self.dw_ops,
                                     [k for _, _, k in cfg.active_res],
                                     [k for _, _, k in cfg.active_dw], "relu", train, h, True)
        else:
            total = None
            for op in self.res_ops:
                y = _apply(op[1], op[0](seg, train, h, True), train, h)
                total = y if total is None else total + y
            for op in self.dw_ops:
                y = _apply(op[2], op[1](op[0](seg, train, h, True), train, h), train, h)
                total = y if total is None else total + y
        gamma, beta = total[:, : self.cfg.norm_nc], total[:, self.cfg.norm_nc:]
        return normalized * (1.0 + gamma) + beta


class SPADEBlock(nn.Module):
    """SPADEInvertedResidualChannels: SPADE norm -> activation -> the sum of
    the multi-branch convs, plus x or the learned shortcut (fin != fout).
    ``packed``: the SPADE norm's branches packed, and the block's where its
    norms are batch norms (as in the JAX package)."""

    def __init__(self, cfg: SPADEBlockConfig, active_fn: str = "leaky_relu",
                 norm_kind: str = "syncbatch", packed: bool = True):
        super().__init__()
        self.cfg, self.active_fn = cfg, active_fn
        self.packed = packed and norm_kind in ("batch", "syncbatch")
        affine, free = _norm_cfg(norm_kind, affine=True), _norm_cfg(norm_kind, affine=False)
        sp, fin, fout = cfg.spectral, cfg.fin, cfg.fout
        if not cfg.is_empty:
            self.spade = InceptionSPADENorm(cfg.spade, packed)
            self.res_ops = nn.ModuleList(
                nn.Sequential(ConvNormActZ(fin, mid, k, affine, active_fn, spectral=sp),
                              PlainConv(mid, fout, k, spectral=sp))
                for _, mid, k in cfg.active_res)
            self.dw_ops = nn.ModuleList(
                nn.Sequential(ConvNormActZ(fin, mid, 1, affine, active_fn, spectral=sp),
                              ConvNormActZ(mid, mid, k, free, active_fn, groups=mid, spectral=sp),
                              PlainConv(mid, fout, 1, spectral=sp))
                for _, mid, k in cfg.active_dw)
        if cfg.learned_shortcut:
            self.shortcut = nn.Sequential(Norm2d(affine, fin),
                                          PlainConv(fin, fout, 1, bias=False, spectral=sp))

    def _shortcut(self, x, train, h):
        return self.shortcut[1](self.shortcut[0](x, train), train, h)

    def forward(self, x, seg, train: bool = False, h: Optional[int] = None):
        """``h``: x's global height over a split height."""
        cfg = self.cfg
        if cfg.is_empty:
            return self._shortcut(x, train, h) if cfg.learned_shortcut else x
        tmp = activation(self.active_fn)(self.spade(x, seg, train, h))
        if self.packed:
            total = _packed_branches(tmp, self.res_ops, self.dw_ops,
                                     [k for _, _, k in cfg.active_res],
                                     [k for _, _, k in cfg.active_dw], self.active_fn, train, h)
        else:
            total = None
            for op in self.res_ops:
                y = op[1](op[0](tmp, train, h), train, h)
                total = y if total is None else total + y
            for op in self.dw_ops:
                y = op[2](op[1](op[0](tmp, train, h), train, h), train, h)
                total = y if total is None else total + y
        return total + (self._shortcut(x, train, h) if cfg.learned_shortcut else x)


class SPADEGenerator(nn.Module):
    """``inception_spade`` generator: NCHW semantics (one-hot labels, the
    dontcare and edge channels) -> NCHW image in [-1, 1]; with ``taps``,
    also a dict of the named blocks' outputs (and ``fc``).  ``packed_blocks``
    picks the blocks' layout (``SPADEBlock``)."""

    def __init__(self, cfg: SPADEGeneratorConfig, init_type: str = "xavier",
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None,
                 packed_blocks: bool = True):
        super().__init__()
        self.cfg = cfg
        self.fc = nn.Conv2d(cfg.semantic_nc, cfg.fc_channels, 3, padding=1)
        self.fc_norm = Norm2d(_norm_cfg(cfg.param_free_norm, affine=True,
                                        momentum=cfg.norm_momentum, eps=cfg.norm_epsilon),
                              cfg.fc_channels)
        for name, bcfg in zip(cfg.block_names, cfg.blocks):
            self.add_module(name, SPADEBlock(bcfg, cfg.active_fn, cfg.param_free_norm,
                                             packed_blocks))
        self.conv_img = nn.Conv2d(cfg.blocks[-1].fout, cfg.output_nc, 3, padding=1)
        init_weights(self, init_type, init_gain, generator)
        # the trunk's and shortcuts' norm scales start at 1, as the JAX package's
        with torch.no_grad():
            for name, m in self.named_modules():
                if name == "fc_norm" or name.endswith("shortcut.0"):
                    if m.weight is not None:
                        m.weight.fill_(1.0)

    def forward(self, seg: torch.Tensor, train: bool = False, taps: Sequence[str] = ()):
        """``seg``, whole on every rank over a split height, gives the
        activations' global heights: the latent's, doubled by each 2x
        resize; the output and the taps are the rank's rows."""
        cfg = self.cfg
        acts: Dict[str, torch.Tensor] = {}
        h, w = cfg.latent_size()
        x = self.fc_norm(spatial.conv2d(self.fc, nearest_resize(seg, h, w), whole=True), train)
        if "fc" in taps:
            acts["fc"] = x
        # 2x nearest before these blocks
        up_between = {"G_middle_0", "up_0", "up_1", "up_2", "up_3", "up_4"}
        if cfg.num_upsampling_layers in ("more", "most"):
            up_between.add("G_middle_1")
        for name in cfg.block_names:
            if name in up_between:
                x = spatial.nearest_resize(x, 2 * h, 2 * x.shape[3], h)
                h *= 2
            x = getattr(self, name)(x, seg, train, h)
            if name in taps:
                acts[name] = x
        y = torch.tanh(spatial.conv2d(self.conv_img, F.leaky_relu(x, 0.2), h))
        return (y, acts) if taps else y


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------


class SPADENLayerDiscriminator(nn.Module):
    """PatchGAN returning every intermediate feature map, for the feature
    matching loss (reference discriminators.py:129-179): ``model{n}`` holds
    layer n's conv at ``.0`` (a normed layer's at ``.0.0``, its norm at
    ``.0.1``), as the reference's ``nn.Sequential``s do."""

    def __init__(self, cfg: MultiscaleDiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        spectral = cfg.norm_D.startswith("spectral")
        subnorm = cfg.norm_D.replace("spectral", "") or "instance"
        kw, padw = 4, 2

        def layer(cin, cout, stride, normed):
            if spectral and normed:
                conv = SpectralConv2d(cin, cout, kw, stride=stride, padding=padw)
            else:
                conv = nn.Conv2d(cin, cout, kw, stride=stride, padding=padw)
            if normed and subnorm != "none":
                conv = nn.Sequential(conv, Norm2d(NormConfig(kind=subnorm, affine=False), cout))
            return nn.Sequential(conv)

        nf = cfg.ndf
        mods = [layer(cfg.input_nc, nf, 2, False)]
        for n in range(1, cfg.n_layers):
            cin, nf = nf, min(nf * 2, 512)
            mods.append(layer(cin, nf, 1 if n == cfg.n_layers - 1 else 2, True))
        mods.append(layer(nf, 1, 1, False))
        for n, m in enumerate(mods):
            self.add_module(f"model{n}", m)

    def forward(self, x, train: bool = False, h: Optional[int] = None) -> List[torch.Tensor]:
        """``h``: x's global height over a split height (learned here when
        not given)."""
        results = []
        n_mods = self.cfg.n_layers + 1
        h = spatial.global_height(x) if h is None else h
        for n in range(n_mods):
            m = getattr(self, f"model{n}")[0]
            conv = m[0] if isinstance(m, nn.Sequential) else m
            y = _apply(conv, x, train, h)
            x = m[1](y, train) if isinstance(m, nn.Sequential) else y
            h = spatial.out_height(h, 4, conv.stride if isinstance(conv, SpectralConv2d)
                                   else conv.stride[0], 2)
            if n < n_mods - 1:
                x = F.leaky_relu(x, 0.2)
            results.append(x)
        return results


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` PatchGANs (``discriminator_{i}``) on an image pyramid of
    3x3 stride-2 average pools that leave the padding out of the divisor."""

    def __init__(self, cfg: MultiscaleDiscriminatorConfig, init_type: str = "xavier",
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_D):
            self.add_module(f"discriminator_{i}", SPADENLayerDiscriminator(cfg))
        init_weights(self, init_type, init_gain, generator)

    def forward(self, x, train: bool = False) -> List[List[torch.Tensor]]:
        outs = []
        h = spatial.global_height(x)  # None unless the height is split
        for i in range(self.cfg.num_D):
            outs.append(getattr(self, f"discriminator_{i}")(x, train, h))
            if i != self.cfg.num_D - 1:
                x = spatial.avg_pool2d(x, 3, 2, 1, h)
                h = spatial.out_height(h, 3, 2, 1)
        return outs
