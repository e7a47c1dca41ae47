"""FLOPs-targeted channel pruning ("shrink") of the inception generator
(port of ``cat_tpu/compress/shrink.py``; numpy arithmetic, identical search).

MACs are a closed-form function of the config (compress/profiling.py), and
MACs(threshold) is a step function whose breakpoints are exactly the
observed |scale| values, so the search binary-searches the sorted unique
|scale| values for the smallest threshold whose architecture fits the
budget.  Given the same scales, it picks the same config as the JAX
package.  The result is a new config plus the teacher's state_dict sliced
to it, in the reference CAT key layout (branch positions renumbered over
the branches that survive).

Deviations from the reference, as in the JAX package: the prune_cin_ub cap
keeps the *largest*-|scale| channels, and the block's pw_bn is sliced
rather than re-initialised.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cat_tpu_torch.core.config import InceptionBlockConfig, InceptionGeneratorConfig
from cat_tpu_torch.compress.profiling import profile_generator
from cat_tpu_torch.compress.prune import (
    PruneGammas,
    collect_prune_gammas,
    dw_in,
    res_in,
    trunk_norm,
    up_norm,
)


@dataclass(frozen=True)
class PruneBounds:
    """Floors/caps on pruned channel counts (reference CLI flags)."""

    cin_lb: int = 1  # --prune_cin_lb: floor for every trunk norm
    cin_ub: Optional[int] = None  # --prune_cin_ub: cap for the first trunk norm
    ft_cin_lb: int = 1  # --prune_ft_cin_lb: floor for the bottleneck norm


@dataclass
class ShrinkMasks:
    ds: List[np.ndarray]  # boolean keep-masks per downsampling norm
    block_res: List[List[np.ndarray]]  # [block][active-res-branch]
    block_dw: List[List[np.ndarray]]
    us: List[np.ndarray]


@dataclass
class ShrinkResult:
    config: InceptionGeneratorConfig
    state_dict: Dict[str, torch.Tensor]  # the teacher's, sliced
    threshold: float
    searched_macs: int
    masks: ShrinkMasks


# ---------------------------------------------------------------------------
# Candidate config at a threshold (search phase: counts with simple clamps,
# reference utils/common.py:345-441)
# ---------------------------------------------------------------------------


def _search_counts(
    g: PruneGammas, t: float, bounds: PruneBounds
) -> Tuple[List[int], List[Tuple[List[int], List[int]]], List[int]]:
    ds = []
    n_ds = len(g.ds)
    for j, gam in enumerate(g.ds):
        c = int((gam > t).sum())
        c = max(c, bounds.cin_lb)
        if j == 0 and bounds.cin_ub is not None:
            c = min(c, bounds.cin_ub)
        if j == n_ds - 1:
            c = max(c, bounds.ft_cin_lb)
        ds.append(c)
    blocks = []
    for bg in g.blocks:
        res = [int((gam > t).sum()) for gam in bg.res]
        dw = [int((gam > t).sum()) for gam in bg.dw]
        blocks.append((res, dw))
    us = [max(int((gam > t).sum()), bounds.cin_lb) for gam in g.us]
    return ds, blocks, us


def _candidate_config(
    cfg: InceptionGeneratorConfig,
    ds: Sequence[int],
    blocks: Sequence[Tuple[List[int], List[int]]],
    us: Sequence[int],
) -> InceptionGeneratorConfig:
    dim = ds[-1]
    new_blocks = []
    for bcfg, (res_counts, dw_counts) in zip(cfg.blocks, blocks):
        # re-expand counts (which cover active branches only) onto the full
        # config tuples, keeping zeros for branches that were already absent
        res = list(bcfg.res_channels)
        for (b, _, _), c in zip(bcfg.active_res, res_counts):
            res[b] = c
        dw = list(bcfg.dw_channels)
        for (b, _, _), c in zip(bcfg.active_dw, dw_counts):
            dw[b] = c
        new_blocks.append(
            InceptionBlockConfig(
                dim=dim,
                res_channels=tuple(res),
                dw_channels=tuple(dw),
                res_kernels=bcfg.res_kernels,
                dw_kernels=bcfg.dw_kernels,
            )
        )
    return dataclasses.replace(
        cfg, ds_channels=tuple(ds), us_channels=tuple(us), blocks=tuple(new_blocks)
    )


def macs_at_threshold(
    cfg: InceptionGeneratorConfig,
    g: PruneGammas,
    t: float,
    bounds: PruneBounds,
    height: int,
    width: int,
) -> int:
    ds, blocks, us = _search_counts(g, t, bounds)
    return profile_generator(_candidate_config(cfg, ds, blocks, us), height, width).macs


# ---------------------------------------------------------------------------
# Final masks (rebuild phase: top-k fallbacks, reference utils/common.py:446-662)
# ---------------------------------------------------------------------------


def _topk_mask(gam: np.ndarray, k: int) -> np.ndarray:
    """Keep channels with |scale| >= the k-th largest (reference uses >=, so
    ties may keep more than k — utils/common.py:454-461).  A floor larger
    than the layer's width keeps every channel."""
    k = min(k, len(gam))
    thresh = np.sort(gam)[::-1][k - 1]
    return gam >= thresh


def _final_masks(g: PruneGammas, t: float, bounds: PruneBounds) -> ShrinkMasks:
    ds = []
    n_ds = len(g.ds)
    for j, gam in enumerate(g.ds):
        mask = gam > t
        if mask.sum() < bounds.cin_lb:
            mask = _topk_mask(gam, bounds.cin_lb)
        if j == 0 and bounds.cin_ub is not None and mask.sum() > bounds.cin_ub:
            # keep the largest scales (sane version of the reference's cap)
            order = np.argsort(-gam)
            mask = np.zeros_like(mask)
            mask[order[: bounds.cin_ub]] = True
        if j == n_ds - 1 and mask.sum() < bounds.ft_cin_lb:
            mask = _topk_mask(gam, bounds.ft_cin_lb)
        ds.append(mask)
    block_res = [[gam > t for gam in bg.res] for bg in g.blocks]
    block_dw = [[gam > t for gam in bg.dw] for bg in g.blocks]
    us = []
    for gam in g.us:
        mask = gam > t
        if mask.sum() < bounds.cin_lb:
            mask = _topk_mask(gam, bounds.cin_lb)
        us.append(mask)
    return ShrinkMasks(ds=ds, block_res=block_res, block_dw=block_dw, us=us)


def _masks_config(
    cfg: InceptionGeneratorConfig, masks: ShrinkMasks
) -> InceptionGeneratorConfig:
    ds = [int(m.sum()) for m in masks.ds]
    blocks = []
    for bres, bdw in zip(masks.block_res, masks.block_dw):
        blocks.append(([int(m.sum()) for m in bres], [int(m.sum()) for m in bdw]))
    us = [int(m.sum()) for m in masks.us]
    return _candidate_config(cfg, ds, blocks, us)


# ---------------------------------------------------------------------------
# State_dict slicing
# ---------------------------------------------------------------------------


def slice_generator_state_dict(
    sd: Dict[str, torch.Tensor], cfg: InceptionGeneratorConfig, masks: ShrinkMasks
) -> Dict[str, torch.Tensor]:
    """The pruned generator's state_dict from the teacher's (reference CAT
    layout; conv weights are OIHW, transposed-conv weights (in, out, kh, kw))."""
    out: Dict[str, torch.Tensor] = {}

    def take(t, dim, mask):
        if mask is None:
            return t.clone()
        return t.index_select(dim, torch.as_tensor(np.flatnonzero(mask), device=t.device))

    def conv(src, dst, in_mask, out_mask, depthwise=False, transposed=False):
        w = sd[f"{src}.weight"]
        in_dim, out_dim = (0, 1) if transposed else (1, 0)
        if not depthwise:
            w = take(w, in_dim, in_mask)
        out[f"{dst}.weight"] = take(w, out_dim, out_mask)
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = take(sd[f"{src}.bias"], 0, out_mask)

    def norm(src, dst, mask):
        for name in ("weight", "bias", "running_mean", "running_var"):
            if f"{src}.{name}" in sd:
                out[f"{dst}.{name}"] = take(sd[f"{src}.{name}"], 0, mask)

    # downsampling trunk: conv j at 3j+1, its norm at 3j+2
    prev = None
    for j, mask in enumerate(masks.ds):
        conv(f"down_sampling.{3 * j + 1}", f"down_sampling.{3 * j + 1}", prev, mask)
        norm(trunk_norm(j), trunk_norm(j), mask)
        prev = mask
    in_mask = prev  # bottleneck mask

    # inception blocks: a branch that lost every channel disappears, and the
    # survivors are renumbered by position
    for i in range(len(cfg.blocks)):
        alive = 0
        pos = 0
        for pos_old, mid_mask in enumerate(masks.block_res[i]):
            if mid_mask.sum() == 0:
                continue
            src, dst = f"features.{i}.res_ops.{pos_old}", f"features.{i}.res_ops.{pos}"
            conv(f"{src}.1.0", f"{dst}.1.0", in_mask, mid_mask)
            norm(res_in(i, pos_old), res_in(i, pos), mid_mask)
            conv(f"{src}.4", f"{dst}.4", mid_mask, in_mask)
            pos += 1
        alive += pos
        pos = 0
        for pos_old, mid_mask in enumerate(masks.block_dw[i]):
            if mid_mask.sum() == 0:
                continue
            src, dst = f"features.{i}.dw_ops.{pos_old}", f"features.{i}.dw_ops.{pos}"
            conv(f"{src}.0.0", f"{dst}.0.0", in_mask, mid_mask)
            norm(dw_in(i, pos_old), dw_in(i, pos), mid_mask)
            conv(f"{src}.2.0", f"{dst}.2.0", None, mid_mask, depthwise=True)
            norm(f"{src}.2.1", f"{dst}.2.1", mid_mask)
            conv(f"{src}.4", f"{dst}.4", mid_mask, in_mask)
            pos += 1
        alive += pos
        if alive:
            norm(f"features.{i}.pw_bn", f"features.{i}.pw_bn", in_mask)

    # upsampling trunk + head
    prev = in_mask
    for j, mask in enumerate(masks.us):
        conv(f"up_sampling.{3 * j}", f"up_sampling.{3 * j}", prev, mask, transposed=True)
        norm(up_norm(j), up_norm(j), mask)
        prev = mask
    head = f"up_sampling.{3 * len(masks.us) + 1}"
    conv(head, head, prev, None)
    return out


# ---------------------------------------------------------------------------
# The shrink search
# ---------------------------------------------------------------------------


def shrink_generator(
    cfg: InceptionGeneratorConfig,
    state_dict: Dict[str, torch.Tensor],
    target_macs: float,
    height: int,
    width: int,
    bounds: PruneBounds = PruneBounds(),
) -> ShrinkResult:
    """Search the pruning threshold hitting ``target_macs`` and emit the
    student (config, sliced state_dict).

    MACs(threshold) only changes at observed |scale| values, so we
    binary-search the sorted unique values for the smallest threshold whose
    architecture fits the budget — the limit point of the reference's float
    binary search (utils/common.py:345-441), computed exactly.
    """
    if target_macs <= 0:
        raise ValueError("target_macs must be positive")
    g = collect_prune_gammas(state_dict, cfg)
    values = np.unique(g.concat())
    if values.size == 0:
        raise ValueError("no prunable scales found")

    def macs(t: float) -> int:
        return macs_at_threshold(cfg, g, t, bounds, height, width)

    if macs(float(values[-1])) > target_macs:
        raise ValueError(
            f"target_macs={target_macs:g} is unreachable: even the maximal "
            f"threshold leaves {macs(float(values[-1])):,} MACs "
            "(bounds floors too high or target too small)"
        )

    lo, hi = 0, values.size - 1  # find smallest index with macs <= target
    while lo < hi:
        mid = (lo + hi) // 2
        if macs(float(values[mid])) <= target_macs:
            hi = mid
        else:
            lo = mid + 1
    threshold = float(values[lo])

    masks = _final_masks(g, threshold, bounds)
    student_cfg = _masks_config(cfg, masks)
    searched = profile_generator(student_cfg, height, width).macs
    student_sd = slice_generator_state_dict(state_dict, cfg, masks)
    return ShrinkResult(
        config=student_cfg,
        state_dict=student_sd,
        threshold=threshold,
        searched_macs=searched,
        masks=masks,
    )
