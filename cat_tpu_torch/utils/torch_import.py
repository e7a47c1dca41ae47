"""Load reference CAT generator checkpoints (port of
``cat_tpu/utils/torch_import.py``).

The reference stores plain ``state_dict`` .pth files and recovers pruned
architectures from tensor shapes.  The port's generator uses the same key
layout, so the state_dict loads as it is; only the config is recovered, by
the same shape rules as the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

from cat_tpu_torch.core.config import InceptionBlockConfig, InceptionGeneratorConfig, NormConfig


def recover_generator_config(
    sd: Dict[str, torch.Tensor],
    input_nc: int = 3,
    output_nc: int = 3,
    norm: NormConfig = NormConfig(kind="instance", affine=True),
    n_ds: int = 3,
    n_blocks: Optional[int] = None,
    padding_type: str = "reflect",
    active_fn: str = "relu",
    dropout_rate: float = 0.0,
) -> InceptionGeneratorConfig:
    """Architecture from checkpoint tensor shapes: branch widths and kernels
    read off the conv weights."""
    ds = [int(sd[f"down_sampling.{1 + 3 * j}.weight"].shape[0]) for j in range(n_ds)]
    us_names = {int(m.group(1)) for k in sd if (m := re.match(r"up_sampling\.(\d+)\.weight", k))}
    # transposed convs come in (convT, norm, relu) triples; the final conv is
    # the head
    n_us = (len(us_names) - 1) // 2
    us = [int(sd[f"up_sampling.{3 * j}.weight"].shape[1]) for j in range(n_us)]

    if n_blocks is None:
        feat_ids = {int(m.group(1)) for k in sd if (m := re.match(r"features\.(\d+)\.", k))}
        n_blocks = (max(feat_ids) + 1) if feat_ids else 0

    blocks = []
    for i in range(n_blocks):
        res_c, res_k, dw_c, dw_k = [], [], [], []
        j = 0
        while f"features.{i}.res_ops.{j}.1.0.weight" in sd:
            w = sd[f"features.{i}.res_ops.{j}.1.0.weight"]
            res_c.append(int(w.shape[0]))
            res_k.append(int(w.shape[2]))
            j += 1
        j = 0
        while f"features.{i}.dw_ops.{j}.2.0.weight" in sd:
            w = sd[f"features.{i}.dw_ops.{j}.2.0.weight"]
            dw_c.append(int(w.shape[0]))
            dw_k.append(int(w.shape[2]))
            j += 1
        blocks.append(InceptionBlockConfig(
            dim=ds[-1], res_channels=tuple(res_c), dw_channels=tuple(dw_c),
            res_kernels=tuple(res_k), dw_kernels=tuple(dw_k),
        ))
    return InceptionGeneratorConfig(
        input_nc=input_nc, output_nc=output_nc, ds_channels=tuple(ds),
        us_channels=tuple(us), blocks=tuple(blocks), norm=norm,
        padding_type=padding_type, active_fn=active_fn, dropout_rate=dropout_rate,
    )


def load_torch_generator(path: str, **kwargs) -> Tuple[InceptionGeneratorConfig,
                                                       Dict[str, torch.Tensor]]:
    """(config recovered from shapes, state_dict) of a reference ``.pth``;
    ``kwargs`` go to ``recover_generator_config``.  The batch norms'
    ``num_batches_tracked`` counters, which nothing here reads, are
    dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return recover_generator_config(sd, **kwargs), sd
