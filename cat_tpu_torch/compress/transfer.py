"""Magnitude-based channel-subset weight transfer from a wide pretrained
generator to a narrower student (port of ``cat_tpu/compress/transfer.py``:
the inception generator, and the SPADE generator below).

At every conv the output channels with the largest L1 mass of |weight|
(taken after slicing the input channels) are kept, in descending order as
``torch.topk`` gives them, and the selected indices become the input
indices of the following norm and conv.  Inside a depthwise branch the 1x1
conv's selection carries through the depthwise stage, and branches pair by
their original index, as in the JAX package.

Works over state_dicts in the reference CAT key layout.  The L1 masses are
summed in numpy over the weight laid out as the JAX package lays it out
(HWIO, transposed kernels flipped), so near-ties break the same way and the
result is the same tensors as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cat_tpu_torch.core.config import InceptionGeneratorConfig
from cat_tpu_torch.core.spade_config import SPADEGeneratorConfig

StateDict = Dict[str, torch.Tensor]


def _topk_desc(q: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest entries, in descending-value order
    (matches torch.topk)."""
    return np.argsort(-q, kind="stable")[:k]


def _pair_branches(src_active, dst_active, what: str) -> List[Tuple[int, int]]:
    """(source position, student position) of each student branch, matched
    by original branch index (a positional zip would pair the wrong kernels
    when the student lost a leading branch)."""
    src_pos = {b: (pos, k) for pos, (b, _, k) in enumerate(src_active)}
    pairs = []
    for pos, (b, _, k) in enumerate(dst_active):
        if b not in src_pos:
            raise KeyError(f"{what}: student branch {b} (k={k}) has no active source "
                           "branch to transfer from")
        if src_pos[b][1] != k:
            raise ValueError(f"{what}: branch {b} kernel mismatch: source "
                             f"k={src_pos[b][1]} vs student k={k}")
        pairs.append((src_pos[b][0], pos))
    return pairs


def _l1_mass(hwio: np.ndarray, in_idx: Optional[np.ndarray]) -> np.ndarray:
    """Per-output-channel L1 mass of an HWIO kernel after slicing inputs."""
    if in_idx is not None:
        hwio = hwio[:, :, in_idx, :]
    return np.abs(hwio).sum(axis=(0, 1, 2))


def _t(idx: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(idx, dtype=np.int64))


class _Transfer:
    def __init__(self, src: StateDict):
        self.src = src
        self.out: StateDict = {}

    def conv(self, src_key: str, dst_key: str, n_out: int, in_idx: Optional[np.ndarray],
             out_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """An OIHW conv: inputs sliced by ``in_idx``, outputs by ``out_idx``
        or the top-``n_out`` L1 masses.  Returns the output indices."""
        name = self._weight_name(src_key)
        w = self.src[f"{src_key}.{name}"]
        if out_idx is None:
            hwio = np.ascontiguousarray(w.numpy().transpose(2, 3, 1, 0))
            out_idx = _topk_desc(_l1_mass(hwio, in_idx), n_out)
        w = w[_t(out_idx)]
        if in_idx is not None:
            w = w[:, _t(in_idx)]
        self.out[f"{dst_key}.{name}"] = w.contiguous()
        self._bias(src_key, dst_key, out_idx)
        return out_idx

    def _weight_name(self, key: str) -> str:
        """A spectrally normalised conv keeps its kernel as ``weight_orig``."""
        return "weight_orig" if f"{key}.weight_orig" in self.src else "weight"

    def conv_t(self, src_key: str, dst_key: str, n_out: int, in_idx: np.ndarray) -> np.ndarray:
        """A transposed conv, torch layout (in, out, kh, kw)."""
        w = self.src[f"{src_key}.weight"]
        hwio = np.ascontiguousarray(w.numpy().transpose(2, 3, 0, 1)[::-1, ::-1])
        out_idx = _topk_desc(_l1_mass(hwio, in_idx), n_out)
        self.out[f"{dst_key}.weight"] = w[_t(in_idx)][:, _t(out_idx)].contiguous()
        self._bias(src_key, dst_key, out_idx)
        return out_idx

    def channels(self, src_key: str, dst_key: str, idx: np.ndarray) -> None:
        """A norm, or a depthwise conv (channel identity fixed): every
        tensor under the key sliced along its first axis."""
        prefix = f"{src_key}."
        for k, v in self.src.items():
            if k.startswith(prefix):
                self.out[f"{dst_key}.{k[len(prefix):]}"] = v[_t(idx)].contiguous()

    def params(self, src_key: str, dst_key: str, idx: np.ndarray) -> None:
        """A norm's or a depthwise conv's parameters (not its running
        statistics or spectral vectors) sliced along their first axis."""
        for name in ("weight", "weight_orig", "bias"):
            if f"{src_key}.{name}" in self.src:
                self.out[f"{dst_key}.{name}"] = self.src[f"{src_key}.{name}"][_t(idx)].contiguous()

    def _bias(self, src_key: str, dst_key: str, idx: np.ndarray) -> None:
        if f"{src_key}.bias" in self.src:
            self.out[f"{dst_key}.bias"] = self.src[f"{src_key}.bias"][_t(idx)].contiguous()


def transfer_generator_state_dict(src_sd: StateDict, src_cfg: InceptionGeneratorConfig,
                                  dst_cfg: InceptionGeneratorConfig) -> StateDict:
    """The student's state_dict from a wider pretrained generator's."""
    tr = _Transfer({k: v.detach().cpu().float() for k, v in src_sd.items()})
    idx: Optional[np.ndarray] = None  # input-channel indices into the source

    # downsampling trunk
    for j, n_out in enumerate(dst_cfg.ds_channels):
        idx = tr.conv(f"down_sampling.{3 * j + 1}", f"down_sampling.{3 * j + 1}", n_out, idx)
        tr.channels(f"down_sampling.{3 * j + 2}", f"down_sampling.{3 * j + 2}", idx)
    block_idx = idx

    # inception blocks
    for i, (sb, db) in enumerate(zip(src_cfg.blocks, dst_cfg.blocks)):
        f = f"features.{i}"
        for ps, pd in _pair_branches(sb.active_res, db.active_res, f"block{i}.res"):
            s, d = f"{f}.res_ops.{ps}", f"{f}.res_ops.{pd}"
            mid = tr.conv(f"{s}.1.0", f"{d}.1.0", db.active_res[pd][1], block_idx)
            tr.channels(f"{s}.1.1", f"{d}.1.1", mid)
            tr.conv(f"{s}.4", f"{d}.4", db.dim, mid, out_idx=block_idx)
        for ps, pd in _pair_branches(sb.active_dw, db.active_dw, f"block{i}.dw"):
            s, d = f"{f}.dw_ops.{ps}", f"{f}.dw_ops.{pd}"
            mid = tr.conv(f"{s}.0.0", f"{d}.0.0", db.active_dw[pd][1], block_idx)
            tr.channels(f"{s}.0.1", f"{d}.0.1", mid)
            tr.channels(f"{s}.2.0", f"{d}.2.0", mid)
            tr.channels(f"{s}.2.1", f"{d}.2.1", mid)
            tr.conv(f"{s}.4", f"{d}.4", db.dim, mid, out_idx=block_idx)
        tr.channels(f"{f}.pw_bn", f"{f}.pw_bn", block_idx)

    # upsampling trunk
    for j, n_out in enumerate(dst_cfg.us_channels):
        idx = tr.conv_t(f"up_sampling.{3 * j}", f"up_sampling.{3 * j}", n_out, idx)
        tr.channels(f"up_sampling.{3 * j + 1}", f"up_sampling.{3 * j + 1}", idx)

    # head: its outputs are the image channels; only its inputs are sliced
    head = f"up_sampling.{3 * len(dst_cfg.us_channels) + 1}"
    src_head = f"up_sampling.{3 * len(src_cfg.us_channels) + 1}"
    tr.out[f"{head}.weight"] = tr.src[f"{src_head}.weight"][:, _t(idx)].contiguous()
    if f"{src_head}.bias" in tr.src:
        tr.out[f"{head}.bias"] = tr.src[f"{src_head}.bias"].clone()
    return tr.out


# ---------------------------------------------------------------------------
# SPADE (inception_spade)
# ---------------------------------------------------------------------------


def _transfer_spade_mlp(tr: _Transfer, key: str, src, dst, idx: np.ndarray) -> None:
    """The γ/β net of a block's SPADE norm (reference transfer_InceptionSPADE,
    weight_transfer.py:186-213): each branch's first conv reads the segmap
    (no input slicing) and keeps its top-k outputs; its last conv's rows are
    the γ rows ``idx`` and the matching β rows ``idx + norm_nc`` (the JAX
    package's coherent reading of the reference's length-norm_nc slice)."""
    out_idx = np.concatenate([idx, np.asarray(idx) + src.norm_nc])
    for ps, pd in _pair_branches(src.active_res, dst.active_res, "spade.res"):
        s, d = f"{key}.res_ops.{ps}", f"{key}.res_ops.{pd}"
        mid = tr.conv(f"{s}.0.conv", f"{d}.0.conv", dst.active_res[pd][1], None)
        tr.params(f"{s}.0.norm", f"{d}.0.norm", mid)
        tr.conv(f"{s}.1", f"{d}.1", 2 * dst.norm_nc, mid, out_idx=out_idx)
    for ps, pd in _pair_branches(src.active_dw, dst.active_dw, "spade.dw"):
        s, d = f"{key}.dw_ops.{ps}", f"{key}.dw_ops.{pd}"
        mid = tr.conv(f"{s}.0.conv", f"{d}.0.conv", dst.active_dw[pd][1], None)
        for sub in ("0.norm", "1.conv", "1.norm"):
            tr.params(f"{s}.{sub}", f"{d}.{sub}", mid)
        tr.conv(f"{s}.2", f"{d}.2", 2 * dst.norm_nc, mid, out_idx=out_idx)


def _transfer_spade_block(tr: _Transfer, name: str, src, dst, idx: np.ndarray) -> np.ndarray:
    """SPADEInvertedResidualChannels (weight_transfer.py:151-183); returns
    the block's output index: the learned shortcut's top-k selection where
    fin != fout, else the input index.  Branch convs transfer as in the
    inception block (the reference's branch loops match no module and leave
    them at their fresh init; the JAX package transfers them)."""
    if src.learned_shortcut != dst.learned_shortcut or len(idx) != dst.fin:
        raise ValueError(f"{name}: the student's block does not follow the source's "
                         f"(shortcut {src.learned_shortcut} vs {dst.learned_shortcut}, "
                         f"{len(idx)} input channels vs fin {dst.fin})")
    if not dst.is_empty:  # an empty block is its shortcut alone
        _transfer_spade_mlp(tr, f"{name}.spade", src.spade, dst.spade, idx)
    out_idx = idx
    if src.learned_shortcut:
        tr.params(f"{name}.shortcut.0", f"{name}.shortcut.0", idx)
        out_idx = tr.conv(f"{name}.shortcut.1.conv", f"{name}.shortcut.1.conv", dst.fout, idx)
    for ps, pd in _pair_branches(src.active_res, dst.active_res, "block.res"):
        s, d = f"{name}.res_ops.{ps}", f"{name}.res_ops.{pd}"
        mid = tr.conv(f"{s}.0.conv", f"{d}.0.conv", dst.active_res[pd][1], idx)
        tr.params(f"{s}.0.norm", f"{d}.0.norm", mid)
        tr.conv(f"{s}.1.conv", f"{d}.1.conv", dst.fout, mid, out_idx=out_idx)
    for ps, pd in _pair_branches(src.active_dw, dst.active_dw, "block.dw"):
        s, d = f"{name}.dw_ops.{ps}", f"{name}.dw_ops.{pd}"
        mid = tr.conv(f"{s}.0.conv", f"{d}.0.conv", dst.active_dw[pd][1], idx)
        for sub in ("0.norm", "1.conv", "1.norm"):
            tr.params(f"{s}.{sub}", f"{d}.{sub}", mid)
        tr.conv(f"{s}.2.conv", f"{d}.2.conv", dst.fout, mid, out_idx=out_idx)
    return out_idx


def transfer_spade_generator_params(src_sd: StateDict, src_cfg: SPADEGeneratorConfig,
                                    dst_cfg: SPADEGeneratorConfig) -> StateDict:
    """The SPADE student's parameters from a wider pretrained generator's
    state_dict (reference load_pretrained_weight's 'inception_spade' chain,
    weight_transfer.py:262-288: fc, fc_norm, the blocks in order, conv_img,
    the selected index threading block to block).  Parameters only: running
    statistics and spectral vectors keep the student's fresh ones, as the
    reference's transfer_Norm never copies statistics
    (weight_transfer.py:83-94)."""
    if (src_cfg.num_upsampling_layers != dst_cfg.num_upsampling_layers
            or src_cfg.semantic_nc != dst_cfg.semantic_nc):
        raise ValueError("transfer_spade_generator_params: the source and the student differ in "
                         "num_upsampling_layers or semantic_nc")
    tr = _Transfer({k: v.detach().cpu().float() for k, v in src_sd.items()})
    idx = tr.conv("fc", "fc", dst_cfg.fc_channels, None)
    tr.params("fc_norm", "fc_norm", idx)
    for name, sb, db in zip(src_cfg.block_names, src_cfg.blocks, dst_cfg.blocks):
        idx = _transfer_spade_block(tr, name, sb, db, idx)
    tr.out["conv_img.weight"] = tr.src["conv_img.weight"][:, _t(idx)].contiguous()
    if "conv_img.bias" in tr.src:
        tr.out["conv_img.bias"] = tr.src["conv_img.bias"].clone()
    return tr.out
