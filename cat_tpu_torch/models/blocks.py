"""Building blocks: the Conv+Norm+Act unit and the multi-branch
inverted-residual "inception" block (port of ``cat_tpu/models/blocks.py``).

Modules are laid out so that their state_dict keys are those of the
reference CAT (models/modules/inception_modules.py): a ``ConvNormAct`` holds
``0`` (conv), ``1`` (norm), ``2`` (activation); a block holds
``res_ops.{pos}`` = (pad, ConvNormAct, dropout, pad, conv) and
``dw_ops.{pos}`` = (ConvNormAct 1x1, pad, ConvNormAct depthwise, dropout,
conv 1x1), where ``pos`` counts the branches that exist, and ``pw_bn``.
Convolutions run VALID after explicit padding, as in the JAX package.
``height``: the input's global height where image height is split over
ranks (``parallel/spatial.py``); the padding then takes the neighbours'
rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cat_tpu_torch.core.config import InceptionBlockConfig, NormConfig
from cat_tpu_torch.ops.instance_norm import fused_instance_norm_act
from cat_tpu_torch.ops.nn import Norm2d, activation, conv2d, instance_norm_f32, spatial_pad
from cat_tpu_torch.parallel import collectives, spatial


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator], height: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from ``generator``; over several
    ranks, the global batch's mask (every image at full height) on every
    rank, this rank's batch rows and height rows kept."""
    if not train or rate <= 0.0:
        return x
    shape = [collectives.global_rows(x.shape[0]), *x.shape[1:]]
    if spatial.active():
        shape[2] = spatial.full_height(x, height)
    mask = torch.rand(shape, generator=generator, device=x.device)
    keep = collectives.local_height(collectives.local_rows(mask)) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


# the activations the fused kernel applies, by the kernel's name
_KERNEL_ACTS = {"relu": "relu", "nn.ReLU": "relu", "none": "none", "identity": "none"}


def kernel_act(norm: NormConfig, act: str, fused: bool) -> Optional[str]:
    """The fused kernel's name for ``act`` where ``fused`` sends an affine
    instance norm followed by ``act`` through the kernel; None where the
    plain path takes it (another norm, no affine, another activation)."""
    if fused and norm.kind == "instance" and norm.affine:
        return _KERNEL_ACTS.get(act)
    return None


def block_norm_sites(cfg: InceptionBlockConfig, packed: bool, act: str) -> list:
    """(channels, activation) of each norm call in one forward of a block of
    config ``cfg`` whose activation is ``act``, in order, from the config
    alone: unpacked, one a residual branch and two a depthwise branch;
    packed, one a kernel-size group of the first convs (the 1x1 group also
    takes every depthwise branch's 1x1) and one for the depthwise stage;
    then ``pw_bn``'s, with no activation.  An empty block has none."""
    if cfg.is_empty:
        return []
    if packed:
        groups: dict = {}
        for _, mid, k in cfg.active_res:
            groups[k] = groups.get(k, 0) + mid
        for _, mid, _ in cfg.active_dw:
            groups[1] = groups.get(1, 0) + mid
        sites = [(groups[k], act) for k in sorted(groups)]
        if cfg.active_dw:
            sites.append((sum(mid for _, mid, _ in cfg.active_dw), act))
    else:
        sites = [(mid, act) for _, mid, _ in cfg.active_res]
        sites += [(mid, act) for _, mid, _ in cfg.active_dw for _ in range(2)]
    return sites + [(cfg.dim, "none")]


def norm_act(x: torch.Tensor, norm: Norm2d, act: str, fused: bool,
             train: bool = False) -> torch.Tensor:
    """norm -> activation: the fused kernel (``ops/instance_norm.py``) where
    ``kernel_act`` allows it, else the plain path, as in the JAX package.
    ``train`` reaches the norm (batch statistics)."""
    kact = kernel_act(norm.cfg, act, fused)
    if kact is not None:
        return fused_instance_norm_act(x.contiguous(), norm.weight.float(), norm.bias.float(),
                                       norm.cfg.eps, kact)
    return activation(act)(norm(x, train))


def conv_norm_act(x: torch.Tensor, conv: nn.Conv2d, norm: Norm2d, act: str,
                  fused: bool, pad: int = 0, pad_mode: str = "reflect",
                  train: bool = False, height: Optional[int] = None) -> torch.Tensor:
    """pad -> conv -> ``norm_act``."""
    return norm_act(conv2d(conv, spatial_pad(x, pad, pad_mode, height), height), norm, act,
                    fused, train)


class ConvNormAct(nn.Sequential):
    """conv -> norm -> activation (reference ConvBNReLU)."""

    def __init__(self, cin: int, cout: int, kernel: int, groups: int = 1,
                 use_bias: bool = True, norm: NormConfig = NormConfig(),
                 act: str = "relu", pad: int = 0, pad_mode: str = "reflect",
                 fused: bool = False):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, groups=groups, bias=use_bias),
            Norm2d(norm, cout),
            nn.Identity(),
        )
        self.act, self.pad, self.pad_mode, self.fused = act, pad, pad_mode, fused

    def forward(self, x: torch.Tensor, train: bool = False,
                height: Optional[int] = None) -> torch.Tensor:
        return conv_norm_act(x, self[0], self[1], self.act, self.fused, self.pad,
                             self.pad_mode, train, height)


def center_pad_kernel(w: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-pad an (out, in, kh, kw) kernel to (out, in, k, k), centred.

    A centred zero-padded kernel applied VALID over ``spatial_pad(x, (k-1)//2)``
    computes exactly the original smaller conv, for any padding mode.
    """
    d = (k - w.shape[-1]) // 2
    if d == 0:
        return w
    return F.pad(w, (d, d, d, d))


class InceptionBlock(nn.Module):
    """Multi-branch inverted-residual block.

    out = x + pw_norm( sum_i res_i(x) + sum_j dw_j(x) )

    Residual branch i (kernel k, mid width m):
      pad(k//2) -> conv(k, m) -> norm -> act -> dropout -> pad(k//2) -> conv(k, dim)
    Depthwise branch j:
      conv(1x1, m) -> norm -> act -> pad(k//2) -> depthwise conv(k) -> norm
      -> act -> dropout -> conv(1x1, dim)

    ``packed=True`` (instance/none norm only) evaluates the same parameters
    with branch convolutions packed into kernel-size-homogeneous groups, as
    ``_packed_call`` does in the JAX package.  ``fused_norms`` sends every
    affine instance norm of the block through the fused kernel (``kernel_act``
    decides): each branch's, or packed, each kernel-size group's and the
    depthwise stage's on the concatenated scales, and ``pw_bn``'s with no
    activation.  An empty block is the identity and owns no parameters.
    """

    def __init__(self, cfg: InceptionBlockConfig, norm: NormConfig = NormConfig(),
                 padding_type: str = "reflect", active_fn: str = "relu",
                 dropout_rate: float = 0.0, use_bias: bool = True,
                 fused_norms: bool = False, packed: bool = False):
        super().__init__()
        self.cfg, self.norm = cfg, norm
        self.padding_type, self.active_fn = padding_type, active_fn
        self.dropout_rate, self.use_bias = dropout_rate, use_bias
        self.fused_norms = fused_norms
        self.packed = packed and norm.kind in ("instance", "none")
        dim = cfg.dim

        def cna(cin, cout, k, groups=1, pad=0):
            return ConvNormAct(cin, cout, k, groups=groups, use_bias=use_bias, norm=norm,
                               act=active_fn, pad=pad, pad_mode=padding_type,
                               fused=fused_norms)

        self.res_ops = nn.ModuleList(
            nn.Sequential(nn.Identity(), cna(dim, mid, k, pad=(k - 1) // 2),
                          nn.Identity(), nn.Identity(),
                          nn.Conv2d(mid, dim, k, bias=use_bias))
            for _, mid, k in cfg.active_res
        )
        self.dw_ops = nn.ModuleList(
            nn.Sequential(cna(dim, mid, 1), nn.Identity(),
                          cna(mid, mid, k, groups=mid, pad=(k - 1) // 2),
                          nn.Identity(), nn.Conv2d(mid, dim, 1, bias=use_bias))
            for _, mid, k in cfg.active_dw
        )
        self.pw_bn = None if cfg.is_empty else Norm2d(norm, dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                height: Optional[int] = None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.is_empty:
            return x
        if spatial.active():
            height = spatial.full_height(x, height)
        if self.packed:
            return self._packed_forward(x, train, generator, height)

        total = None
        for (_, _, k), ops in zip(cfg.active_res, self.res_ops):
            h = dropout(ops[1](x, train, height), self.dropout_rate, train, generator, height)
            h = ops[4](spatial_pad(h, (k - 1) // 2, self.padding_type, height))
            total = h if total is None else total + h
        for ops in self.dw_ops:
            h = ops[2](ops[0](x, train), train, height)
            h = ops[4](dropout(h, self.dropout_rate, train, generator, height))
            total = h if total is None else total + h
        return x + norm_act(total, self.pw_bn, "none", self.fused_norms, train)

    # ------------------------------------------------------------- packed

    def _inorm_act(self, y, scale, bias):
        """Norm2d's instance-norm numerics on a packed tensor, with the
        activation applied in float32 before the cast back: the fused
        kernel's where ``kernel_act`` allows it."""
        kact = kernel_act(self.norm, self.active_fn, self.fused_norms)
        if kact is not None:
            return fused_instance_norm_act(y, scale.float(), bias.float(), self.norm.eps, kact)
        yf = y.float()
        if self.norm.kind == "instance":
            yf = instance_norm_f32(yf, scale, bias, self.norm.eps)
        return activation(self.active_fn)(yf).to(y.dtype)

    def _packed_forward(self, x, train, generator, height=None):
        """Grouped branch packing: FLOP-exact, kernel-size-homogeneous groups.

        Branch convs sharing a kernel size pack into one wide conv (the k=1
        group carries the res k=1 branch and every dw 1x1, res first); the
        depthwise stage is one grouped conv over all dw channels with each
        kernel zero-padded to the largest; "out" convs group the same way,
        each emitting a partial branch sum.
        """
        cfg = self.cfg
        affine = self.norm.kind == "instance" and self.norm.affine
        pad_mode = self.padding_type
        res = [(mid, k, ops[1], ops[4]) for (_, mid, k), ops in zip(cfg.active_res, self.res_ops)]
        dw = [(mid, k, ops[0], ops[2], ops[4]) for (_, mid, k), ops in zip(cfg.active_dw, self.dw_ops)]

        # ---- IN: one conv per kernel-size group (res first, dw last in k=1) ----
        groups: dict = {}
        for mid, k, cin_unit, _ in res:
            groups.setdefault(k, []).append(("res", mid, cin_unit))
        for mid, _, cin_unit, _, _ in dw:
            groups.setdefault(1, []).append(("dw", mid, cin_unit))

        h_res, g_parts = {}, []  # res unit -> its mid activation; dw mids in order
        for k in sorted(groups):
            units = [u for _, _, u in groups[k]]
            y = F.conv2d(spatial_pad(x, (k - 1) // 2, pad_mode, height),
                         torch.cat([u[0].weight for u in units]),
                         torch.cat([u[0].bias for u in units]) if self.use_bias else None)
            sc = torch.cat([u[1].weight for u in units]) if affine else None
            bi = torch.cat([u[1].bias for u in units]) if affine else None
            y = self._inorm_act(y, sc, bi)
            off = 0
            for kind, mid, unit in groups[k]:
                sl = y[:, off:off + mid]
                if kind == "res":
                    h_res[unit] = dropout(sl, self.dropout_rate, train, generator, height)
                else:
                    g_parts.append(sl)
                off += mid

        # ---- dw depthwise stage: one grouped conv over all dw channels ----
        gm_parts = []
        if dw:
            g_all = g_parts[0] if len(g_parts) == 1 else torch.cat(g_parts, 1)
            kmax = max(k for _, k, _, _, _ in dw)
            mids = [mid_unit for _, _, _, mid_unit, _ in dw]
            w_dw = torch.cat([center_pad_kernel(u[0].weight, kmax) for u in mids])
            gm = F.conv2d(spatial_pad(g_all, (kmax - 1) // 2, pad_mode, height), w_dw,
                          torch.cat([u[0].bias for u in mids]) if self.use_bias else None,
                          groups=g_all.shape[1])
            gm = self._inorm_act(
                gm,
                torch.cat([u[1].weight for u in mids]) if affine else None,
                torch.cat([u[1].bias for u in mids]) if affine else None,
            )
            gm = dropout(gm, self.dropout_rate, train, generator, height)
            off = 0
            for mid, _, _, _, _ in dw:
                gm_parts.append(gm[:, off:off + mid])
                off += mid

        # ---- OUT: one conv per kernel-size group, emitting partial sums ----
        og: dict = {}  # insertion order as in the JAX package (bias sum order)
        for _, k, cin_unit, out_conv in res:
            og.setdefault(k, []).append((h_res[cin_unit], out_conv))
        for part, (_, _, _, _, out_conv) in zip(gm_parts, dw):
            og.setdefault(1, []).append((part, out_conv))

        total = None
        for k in sorted(og):
            ts = [t for t, _ in og[k]]
            xin = ts[0] if len(ts) == 1 else torch.cat(ts, 1)
            y = F.conv2d(spatial_pad(xin, (k - 1) // 2, pad_mode, height),
                         torch.cat([c.weight for _, c in og[k]], 1))
            total = y if total is None else total + y
        if self.use_bias:
            bsum = sum(c.bias for group in og.values() for _, c in group)
            total = total + bsum[:, None, None]
        return x + norm_act(total, self.pw_bn, "none", self.fused_norms, train)
