"""SPADE generator: analytic profiling and the FLOPs-targeted shrink (port of
``cat_tpu/compress/spade.py``).

Reference: utils/common.py:710-869 (shrink_spade_model) and
utils/model_profiling.py (the SPADE accumulation, 170-204).

Profiling: every norm of the SPADE stack is a running-statistics sync batch
norm, which the reference counts as 0 MACs and 0 parameters
(model_profiling.py:116-125), so a SPADE generator's MACs are its convs'.

Shrink (utils/common.py:734-821):
  * the trunk width (fc_norm) is pruned in multiples of 16 (32 for
    ``num_upsampling_layers == 'most'``), the prune_cin_lb/ub bounds applied
    to the count of multiples;
  * each block's branch widths and its nested SPADE branch widths threshold
    on their first norm's |scale| with no floor;
  * block fin/fout follow the trunk: f, f, f, f/2, f/4, ...  The result is
    an architecture; the caller initialises the student afresh.

The scales are read from the port's state_dict, whose ``nn.ModuleList``s
hold only the branches that exist: the branch of config index ``b`` sits at
its position among the active branches, where the JAX tree names it
``res{b}_in`` / ``dw{b}_in``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from cat_tpu_torch.compress.profiling import GeneratorProfile
from cat_tpu_torch.compress.shrink import PruneBounds
from cat_tpu_torch.core.spade_config import SPADEBlockConfig, SPADEGeneratorConfig

# ---------------------------------------------------------------------------
# analytic profiling
# ---------------------------------------------------------------------------


def _conv_macs(cin, cout, k, h, w, groups=1):
    return cin * cout * k * k * h * w // groups


def _conv_params(cin, cout, k, groups=1, bias=True):
    return cin * cout * k * k // groups + (cout if bias else 0)


def _branches(active_res, active_dw, cin, cout, h, w) -> Tuple[int, int]:
    """A multi-branch stack: each res branch a k x k conv to ``mid`` and one
    back to ``cout``; each dw branch 1x1, depthwise k x k, 1x1."""
    macs = params = 0
    for _, mid, k in active_res:
        macs += _conv_macs(cin, mid, k, h, w) + _conv_macs(mid, cout, k, h, w)
        params += _conv_params(cin, mid, k) + _conv_params(mid, cout, k)
    for _, mid, k in active_dw:
        macs += (_conv_macs(cin, mid, 1, h, w) + _conv_macs(mid, mid, k, h, w, groups=mid)
                 + _conv_macs(mid, cout, 1, h, w))
        params += (_conv_params(cin, mid, 1) + _conv_params(mid, mid, k, groups=mid)
                   + _conv_params(mid, cout, 1))
    return macs, params


def profile_spade_block(cfg: SPADEBlockConfig, h: int, w: int) -> Tuple[int, int]:
    macs = params = 0
    if not cfg.is_empty:
        sp = cfg.spade  # γ and β from the segmap at (h, w)
        m, p = _branches(sp.active_res, sp.active_dw, sp.label_nc, 2 * sp.norm_nc, h, w)
        m2, p2 = _branches(cfg.active_res, cfg.active_dw, cfg.fin, cfg.fout, h, w)
        macs, params = m + m2, p + p2
    if cfg.learned_shortcut:
        macs += _conv_macs(cfg.fin, cfg.fout, 1, h, w)
        params += _conv_params(cfg.fin, cfg.fout, 1, bias=False)
    return macs, params


def profile_spade_generator(cfg: SPADEGeneratorConfig, height: int,
                            width: int) -> GeneratorProfile:
    """MACs and parameters at a segmap size (batch 1)."""
    prof = GeneratorProfile()
    sh, sw = cfg.latent_size()
    prof.add("fc", _conv_macs(cfg.semantic_nc, cfg.fc_channels, 3, sh, sw),
             _conv_params(cfg.semantic_nc, cfg.fc_channels, 3))
    h, w = sh, sw
    up_between = {"G_middle_0", "up_0", "up_1", "up_2", "up_3", "up_4"}
    if cfg.num_upsampling_layers in ("more", "most"):
        up_between.add("G_middle_1")
    for name, bcfg in zip(cfg.block_names, cfg.blocks):
        if name in up_between:
            h, w = h * 2, w * 2
        prof.add(name, *profile_spade_block(bcfg, h, w))
    prof.add("conv_img", _conv_macs(cfg.blocks[-1].fout, cfg.output_nc, 3, h, w),
             _conv_params(cfg.blocks[-1].fout, cfg.output_nc, 3))
    return prof


# ---------------------------------------------------------------------------
# gamma collection
# ---------------------------------------------------------------------------


@dataclass
class SpadeBlockGammas:
    res: List[np.ndarray]
    dw: List[np.ndarray]
    sp_res: List[np.ndarray]
    sp_dw: List[np.ndarray]


@dataclass
class SpadeGammas:
    fc: np.ndarray
    blocks: List[SpadeBlockGammas]

    def concat(self) -> np.ndarray:
        parts = [self.fc]
        for b in self.blocks:
            parts.extend(b.res + b.dw + b.sp_res + b.sp_dw)
        return np.concatenate(parts)


def collect_spade_gammas(state_dict: Dict[str, torch.Tensor],
                         cfg: SPADEGeneratorConfig) -> SpadeGammas:
    """|scale| of fc_norm, of each block branch's first norm and of each
    nested SPADE branch's first norm (reference utils/prune.py:17-37 with
    spade=True), in float64, in the JAX package's order."""

    def g(key):
        return np.abs(state_dict[f"{key}.weight"].detach().cpu().double().numpy())

    def first_norms(prefix, active):
        return [g(f"{prefix}.{pos}.0.norm") for pos in range(len(active))]

    blocks = []
    for name, bcfg in zip(cfg.block_names, cfg.blocks):
        blocks.append(SpadeBlockGammas(
            res=first_norms(f"{name}.res_ops", bcfg.active_res),
            dw=first_norms(f"{name}.dw_ops", bcfg.active_dw),
            sp_res=first_norms(f"{name}.spade.res_ops", bcfg.spade.active_res),
            sp_dw=first_norms(f"{name}.spade.dw_ops", bcfg.spade.active_dw)))
    return SpadeGammas(fc=g("fc_norm"), blocks=blocks)


# ---------------------------------------------------------------------------
# shrink
# ---------------------------------------------------------------------------


@dataclass
class SpadeShrinkResult:
    config: SPADEGeneratorConfig
    threshold: float
    searched_macs: int


def _remap(active, counts, full) -> Tuple[int, ...]:
    """The width tuple with each active branch's width replaced by its count
    (a pruned-away branch keeps its place, at width 0)."""
    vals = list(full)
    for (b, _, _), c in zip(active, counts):
        vals[b] = c
    return tuple(vals)


def _spade_candidate(cfg: SPADEGeneratorConfig, g: SpadeGammas, t: float,
                     bounds: PruneBounds) -> SPADEGeneratorConfig:
    ch_div = 32 if cfg.num_upsampling_layers == "most" else 16
    fc = max(int((g.fc > t).sum()) // ch_div, bounds.cin_lb) * ch_div
    if bounds.cin_ub is not None:
        fc = min(fc // ch_div, bounds.cin_ub) * ch_div

    def kept(gammas):
        return [int((x > t).sum()) for x in gammas]

    new_blocks, f = [], fc
    for name, bcfg, bg in zip(cfg.block_names, cfg.blocks, g.blocks):
        fin, fout = f, (f // 2 if name.startswith("up") else f)
        f = fout
        sp = bcfg.spade
        new_blocks.append(dataclasses.replace(
            bcfg, fin=fin, fout=fout,
            res_channels=_remap(bcfg.active_res, kept(bg.res), bcfg.res_channels),
            dw_channels=_remap(bcfg.active_dw, kept(bg.dw), bcfg.dw_channels),
            spade=dataclasses.replace(
                sp, norm_nc=fin,
                res_channels=_remap(sp.active_res, kept(bg.sp_res), sp.res_channels),
                dw_channels=_remap(sp.active_dw, kept(bg.sp_dw), sp.dw_channels))))
    return dataclasses.replace(cfg, fc_channels=fc, blocks=tuple(new_blocks))


def shrink_spade_generator(cfg: SPADEGeneratorConfig, state_dict: Dict[str, torch.Tensor],
                           target_macs: float, height: int, width: int,
                           bounds: PruneBounds = PruneBounds()) -> SpadeShrinkResult:
    """The threshold search over the sorted unique |scale| values (the
    reference's float binary search's limit, computed exactly): the smallest
    threshold whose candidate fits ``target_macs``.  Architecture only."""
    g = collect_spade_gammas(state_dict, cfg)
    values = np.unique(g.concat())

    def macs(t: float) -> int:
        return profile_spade_generator(_spade_candidate(cfg, g, t, bounds), height, width).macs

    if macs(float(values[-1])) > target_macs:
        raise ValueError(f"target_macs={target_macs:g} unreachable (floor leaves "
                         f"{macs(float(values[-1])):,} MACs)")
    lo, hi = 0, values.size - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if macs(float(values[mid])) <= target_macs:
            hi = mid
        else:
            lo = mid + 1
    t = float(values[lo])
    student = _spade_candidate(cfg, g, t, bounds)
    return SpadeShrinkResult(config=student, threshold=t,
                             searched_macs=profile_spade_generator(student, height, width).macs)
