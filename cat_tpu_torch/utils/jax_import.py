"""Carry weights of the JAX package into the port.

A JAX generator, NLayer-discriminator or distillation-adaptor parameter
tree, given as nested dicts of numpy arrays (``variables["params"]``, as
``utils/checkpoint.py::read_msgpack`` returns it from a ``.msgpack`` file),
becomes the port's state_dict in the reference CAT key layout, so
``cat_tpu/utils/torch_import.py::import_inception_generator`` carries the
port's generator weights back unchanged.

Layouts:
  conv       HWIO (kh, kw, in, out)  -> OIHW  kernel.transpose(3, 2, 0, 1)
  depthwise  (kh, kw, 1, ch)         -> (ch, 1, kh, kw), the same transpose
  convT      HWIO of the input-dilated conv -> torch (in, out, kh, kw):
             transpose(2, 3, 0, 1), then flip kh and kw (the inverse of
             ``torch_import._convt``)
  norm       scale / bias -> weight / bias
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cat_tpu_torch.core.config import (
    InceptionBlockConfig,
    InceptionGeneratorConfig,
    NLayerDiscriminatorConfig,
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: Dict, key: str, p: Dict) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _convt(sd: Dict, key: str, p: Dict) -> None:
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[f"{key}.weight"] = _t(w)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: Dict, key: str, p: Dict) -> None:
    if p is not None:
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])


def inception_block_state_dict(bp: Dict, bcfg: InceptionBlockConfig) -> Dict[str, torch.Tensor]:
    """The port's ``InceptionBlock`` state_dict from a JAX block's params.
    Branches are numbered by position among the branches that exist; the
    JAX tree names them by config index."""
    sd: Dict[str, torch.Tensor] = {}
    for pos, (b, _, _) in enumerate(bcfg.active_res):
        key = f"res_ops.{pos}"
        _conv(sd, f"{key}.1.0", bp[f"res{b}_in"]["conv"])
        _norm(sd, f"{key}.1.1", bp[f"res{b}_in"].get("norm"))
        _conv(sd, f"{key}.4", bp[f"res{b}_out"])
    for pos, (b, _, _) in enumerate(bcfg.active_dw):
        key = f"dw_ops.{pos}"
        _conv(sd, f"{key}.0.0", bp[f"dw{b}_in"]["conv"])
        _norm(sd, f"{key}.0.1", bp[f"dw{b}_in"].get("norm"))
        _conv(sd, f"{key}.2.0", bp[f"dw{b}_mid"]["conv"])
        _norm(sd, f"{key}.2.1", bp[f"dw{b}_mid"].get("norm"))
        _conv(sd, f"{key}.4", bp[f"dw{b}_out"])
    _norm(sd, "pw_bn", bp.get("pw_norm"))
    return sd


def generator_state_dict(params: Dict, cfg: InceptionGeneratorConfig) -> Dict[str, torch.Tensor]:
    """The port's ``InceptionGenerator`` state_dict from a JAX generator's
    ``params`` tree."""
    sd: Dict[str, torch.Tensor] = {}
    trunk = ["stem"] + [f"down{j}" for j in range(len(cfg.ds_channels) - 1)]
    for j, name in enumerate(trunk):
        _conv(sd, f"down_sampling.{3 * j + 1}", params[name]["conv"])
        _norm(sd, f"down_sampling.{3 * j + 2}", params[name].get("norm"))

    for i, bcfg in enumerate(cfg.blocks):
        for k, v in inception_block_state_dict(params.get(f"block{i}", {}), bcfg).items():
            sd[f"features.{i}.{k}"] = v

    for j in range(len(cfg.us_channels)):
        _convt(sd, f"up_sampling.{3 * j}", params[f"up{j}_conv"])
        _norm(sd, f"up_sampling.{3 * j + 1}", params.get(f"up{j}_norm"))
    _conv(sd, f"up_sampling.{3 * len(cfg.us_channels) + 1}", params["head"])
    return sd


def nlayer_discriminator_state_dict(params: Dict, cfg: NLayerDiscriminatorConfig
                                    ) -> Dict[str, torch.Tensor]:
    """The port's ``NLayerDiscriminator`` state_dict (``model.{i}``) from a
    JAX NLayer discriminator's ``params`` tree."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "model.0", params["conv0"])
    for n in range(1, cfg.n_layers + 1):
        _conv(sd, f"model.{3 * n - 1}", params[f"conv{n}"])
        _norm(sd, f"model.{3 * n}", params.get(f"norm{n}"))
    _conv(sd, f"model.{3 * cfg.n_layers + 2}", params["conv_out"])
    return sd


def adaptor_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's adaptor state_dict (``A{i}.weight`` / ``A{i}.bias``, 1x1
    convs) from the JAX distiller's adaptor params ``{"A{i}": {"conv": ...}}``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _conv(sd, name, p["conv"])
    return sd


def distill_state_dict(tree: Dict, student_cfg: InceptionGeneratorConfig,
                       disc_cfg: NLayerDiscriminatorConfig, adaptors: bool) -> Dict:
    """The port's train-state dict (``train/common.py::train_state_dict``'s
    layout) from the JAX distiller's full state tree (a ``<tag>_state.msgpack``
    as ``checkpoint.read_msgpack`` returns it): parameters, Adam moments and
    counts, step and EMA.  Adam moments take the parameters' layout changes.
    ``adaptors``: keep the adaptor group (the port has one only for mse).
    The dropout RNG does not carry over: a JAX key is no torch.Generator."""

    def gen(t):
        return generator_state_dict(t, student_cfg)

    def disc(t):
        return nlayer_discriminator_state_dict(t, disc_cfg)

    def g_group(t):  # the {G, A} group, adaptors prefixed as the port's optimiser names them
        a = {f"A.{k}": v for k, v in adaptor_state_dict(t.get("A") or {}).items()}
        return {**gen(t["G"]), **(a if adaptors else {})}

    g, d = tree["g"], tree["d"]
    extra = tree.get("extra") or {}
    return {
        "step": int(np.asarray(tree["step"])),
        "g": {"params": gen(g["params"]["G"]),
              "opt": {"count": int(np.asarray(g["opt_state"]["count"])),
                      "mu": g_group(g["opt_state"]["mu"]), "nu": g_group(g["opt_state"]["nu"])}},
        "d": {"params": disc(d["params"]),
              "opt": {"count": int(np.asarray(d["opt_state"]["count"])),
                      "mu": disc(d["opt_state"]["mu"]), "nu": disc(d["opt_state"]["nu"])}},
        "adaptors": adaptor_state_dict(g["params"].get("A") or {}) if adaptors else {},
        "extra": {"ema_G": gen(extra["ema_G"])} if "ema_G" in extra else {},
    }
