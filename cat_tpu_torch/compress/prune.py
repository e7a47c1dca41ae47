"""Collection of prunable norm-scale vectors from a generator's state_dict
(port of ``cat_tpu/compress/prune.py``).

The channel-pruning signal is |scale| of:
  * every norm in the downsampling trunk (stem + down{j}),
  * the *first* norm of every inception-block branch,
  * every norm in the upsampling trunk,
in the reference's concatenation order (utils/prune.py:5-61).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from cat_tpu_torch.core.config import InceptionGeneratorConfig


# state_dict prefixes of the prunable norms (reference CAT layout)
def trunk_norm(j: int) -> str:
    """Norm of trunk conv j (0 = stem, j >= 1 = down{j-1})."""
    return f"down_sampling.{2 + 3 * j}"


def res_in(i: int, pos: int) -> str:
    return f"features.{i}.res_ops.{pos}.1.1"


def dw_in(i: int, pos: int) -> str:
    return f"features.{i}.dw_ops.{pos}.0.1"


def up_norm(j: int) -> str:
    return f"up_sampling.{3 * j + 1}"


def _gamma(sd: Dict, prefix: str) -> np.ndarray:
    return np.abs(sd[f"{prefix}.weight"].detach().cpu().numpy().astype(np.float64))


@dataclass
class BlockGammas:
    res: List[np.ndarray]  # |scale| per active res branch (config order)
    dw: List[np.ndarray]


@dataclass
class PruneGammas:
    """All prunable |scale| vectors, in the reference's concatenation order."""

    ds: List[np.ndarray]
    blocks: List[BlockGammas]
    us: List[np.ndarray]

    def concat(self) -> np.ndarray:
        parts = list(self.ds)
        for b in self.blocks:
            parts.extend(b.res)
            parts.extend(b.dw)
        parts.extend(self.us)
        return np.concatenate(parts) if parts else np.zeros((0,))


def collect_prune_gammas(sd: Dict, cfg: InceptionGeneratorConfig) -> PruneGammas:
    if not cfg.norm.has_scale:
        raise ValueError(
            "channel pruning requires affine norm layers (γ scaling factors); "
            f"got norm={cfg.norm}"
        )
    ds = [_gamma(sd, trunk_norm(j)) for j in range(len(cfg.ds_channels))]
    blocks = [
        BlockGammas(
            res=[_gamma(sd, res_in(i, pos)) for pos in range(len(bcfg.active_res))],
            dw=[_gamma(sd, dw_in(i, pos)) for pos in range(len(bcfg.active_dw))],
        )
        for i, bcfg in enumerate(cfg.blocks)
    ]
    us = [_gamma(sd, up_norm(j)) for j in range(len(cfg.us_channels))]
    return PruneGammas(ds=ds, blocks=blocks, us=us)
