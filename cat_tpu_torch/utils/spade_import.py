"""Load reference (PyTorch) SPADE generator checkpoints (port of
``cat_tpu/utils/spade_import.py``).

The port's ``SPADEGenerator`` uses the reference's key layout
(models/modules/inception_modules.py:345-769,
inception_architecture/inception_spade_generator.py), so a reference
state_dict loads into it strictly, with no renames.  What has to be
recovered is the architecture, from the tensors' shapes (pruned students
included, utils/common.py:183-312):

  fc / fc_norm / conv_img
  <block>.res_ops.{j} = [ConvSyncBNReLU(conv, norm), Conv(conv)]
  <block>.dw_ops.{j}  = [ConvSyncBNReLU, ConvSyncBNReLU(depthwise), Conv]
  <block>.shortcut    = [norm, Conv]                (when fin != fout)
  <block>.spade.param_free_norm                     (affine-free)
  <block>.spade.res_ops.{j} = [ConvSyncBNReLU, nn.Conv2d]
  <block>.spade.dw_ops.{j}  = [ConvSyncBNReLU, ConvSyncBNReLU(dw), nn.Conv2d]

``num_upsampling_layers`` cannot be read from the weights (it moves an
upsample, reference generator :84-87) and must be given, with the crop,
aspect ratio and norm kinds.  A spectrally normalised conv keeps its kernel
as ``weight_orig``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cat_tpu_torch.core.spade_config import (SPADEBlockConfig, SPADEGeneratorConfig,
                                             SPADELayerConfig, spade_block_names)


def _weight(sd: Dict[str, torch.Tensor], key: str):
    return sd.get(f"{key}.weight", sd.get(f"{key}.weight_orig"))


def _branch_spec(sd, prefix: str, conv_sub: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(output channels, kernel sizes) of the convs ``{prefix}.{j}.{conv_sub}``
    for j = 0, 1, ... while they exist."""
    chans, kerns, j = [], [], 0
    while (w := _weight(sd, f"{prefix}.{j}.{conv_sub}")) is not None:
        chans.append(int(w.shape[0]))
        kerns.append(int(w.shape[2]))
        j += 1
    return tuple(chans), tuple(kerns)


def recover_spade_config(sd: Dict[str, torch.Tensor], num_upsampling_layers: str = "more",
                         crop_size: int = 512, aspect_ratio: float = 2.0,
                         param_free_norm: str = "syncbatch",
                         spectral: bool = False) -> SPADEGeneratorConfig:
    """The generator config a reference state_dict describes."""
    fc, semantic_nc = (int(n) for n in sd["fc.weight"].shape[:2])
    blocks, f = [], fc
    for name in spade_block_names(num_upsampling_layers):
        fin, fout = f, (f // 2 if name.startswith("up") else f)
        f = fout
        # a res branch's kernel is its convs'; a dw branch's its depthwise conv's
        res_c, res_k = _branch_spec(sd, f"{name}.res_ops", "0.conv")
        _, res_k2 = _branch_spec(sd, f"{name}.res_ops", "1.conv")
        dw_c, _ = _branch_spec(sd, f"{name}.dw_ops", "0.conv")
        _, dw_k = _branch_spec(sd, f"{name}.dw_ops", "1.conv")
        sp_res_c, _ = _branch_spec(sd, f"{name}.spade.res_ops", "0.conv")
        _, sp_res_k = _branch_spec(sd, f"{name}.spade.res_ops", "1")
        sp_dw_c, _ = _branch_spec(sd, f"{name}.spade.dw_ops", "0.conv")
        _, sp_dw_k = _branch_spec(sd, f"{name}.spade.dw_ops", "1.conv")
        blocks.append(SPADEBlockConfig(
            fin=fin, fout=fout, res_channels=res_c, dw_channels=dw_c,
            res_kernels=res_k2 or res_k, dw_kernels=dw_k,
            spade=SPADELayerConfig(norm_nc=fin, label_nc=semantic_nc, res_channels=sp_res_c,
                                   dw_channels=sp_dw_c, res_kernels=sp_res_k,
                                   dw_kernels=sp_dw_k, param_free_norm=param_free_norm),
            spectral=spectral))
    return SPADEGeneratorConfig(semantic_nc=semantic_nc, fc_channels=fc,
                                num_upsampling_layers=num_upsampling_layers, crop_size=crop_size,
                                aspect_ratio=aspect_ratio, blocks=tuple(blocks),
                                param_free_norm=param_free_norm, spectral=spectral)


def load_torch_spade_generator(path: str, **cfg_kwargs
                               ) -> Tuple[SPADEGeneratorConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) of a reference ``.pth``: the architecture
    recovered from its shapes (``cfg_kwargs`` as ``recover_spade_config``
    takes them), the weights loaded strictly into the port's generator."""
    from cat_tpu_torch.models.spade import SPADEGenerator

    sd = torch.load(path, map_location="cpu", weights_only=True)
    cfg = recover_spade_config(sd, **cfg_kwargs)
    gen = SPADEGenerator(cfg)
    gen.load_state_dict(sd)
    return cfg, gen.state_dict()
