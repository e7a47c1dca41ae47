"""Carry weights of the JAX package into the port.

A JAX generator, NLayer- or pixel-discriminator or distillation-adaptor
parameter tree, given as nested dicts of numpy arrays (``variables["params"]``,
as ``utils/checkpoint.py::read_msgpack`` returns it from a ``.msgpack`` file),
with its batch-norm statistics tree (``variables["batch_stats"]``, the same
paths as the parameters), becomes the port's state_dict in the reference CAT
key layout, so ``cat_tpu/utils/torch_import.py::import_inception_generator``
carries the port's generator weights back unchanged.  So do whole train
states of the JAX distiller, pix2pix and CycleGAN tasks.

Layouts:
  conv       HWIO (kh, kw, in, out)  -> OIHW  kernel.transpose(3, 2, 0, 1)
  depthwise  (kh, kw, 1, ch)         -> (ch, 1, kh, kw), the same transpose
  convT      HWIO of the input-dilated conv -> torch (in, out, kh, kw):
             transpose(2, 3, 0, 1), then flip kh and kw (the inverse of
             ``torch_import._convt``)
  norm       scale / bias -> weight / bias; mean / var -> running_mean /
             running_var (a tracked norm without statistics in the tree
             starts at 0 / 1, as a fresh one does)
  pool       (pool_size, H, W, C) -> (pool_size, C, H, W)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cat_tpu_torch.core.config import (
    InceptionBlockConfig,
    InceptionGeneratorConfig,
    NLayerDiscriminatorConfig,
    NormConfig,
    PixelDiscriminatorConfig,
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


def _norm(sd: Dict, key: str, p: Optional[Dict], s: Optional[Dict], norm: NormConfig,
          channels: int) -> None:
    """A norm's parameters ``p`` and running statistics ``s`` (either may
    be None)."""
    if p is not None:
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])
    if norm.is_batch_like and norm.track_running_stats:
        sd[f"{key}.running_mean"] = _t(s["mean"]) if s else torch.zeros(channels)
        sd[f"{key}.running_var"] = _t(s["var"]) if s else torch.ones(channels)


def _sub(tree: Optional[Dict], *path: str) -> Optional[Dict]:
    for k in path:
        if not tree or k not in tree:
            return None
        tree = tree[k]
    return tree


def inception_block_state_dict(bp: Dict, bcfg: InceptionBlockConfig,
                               norm: NormConfig = NormConfig(),
                               bs: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's ``InceptionBlock`` state_dict from a JAX block's params
    (and statistics ``bs``).  Branches are numbered by position among the
    branches that exist; the JAX tree names them by config index."""
    sd: Dict[str, torch.Tensor] = {}
    for pos, (b, mid, _) in enumerate(bcfg.active_res):
        key, name = f"res_ops.{pos}", f"res{b}_in"
        _conv(sd, f"{key}.1.0", bp[name]["conv"])
        _norm(sd, f"{key}.1.1", bp[name].get("norm"), _sub(bs, name, "norm"), norm, mid)
        _conv(sd, f"{key}.4", bp[f"res{b}_out"])
    for pos, (b, mid, _) in enumerate(bcfg.active_dw):
        key = f"dw_ops.{pos}"
        for name, sub in ((f"dw{b}_in", "0"), (f"dw{b}_mid", "2")):
            _conv(sd, f"{key}.{sub}.0", bp[name]["conv"])
            _norm(sd, f"{key}.{sub}.1", bp[name].get("norm"), _sub(bs, name, "norm"), norm,
                  mid)
        _conv(sd, f"{key}.4", bp[f"dw{b}_out"])
    if not bcfg.is_empty:
        _norm(sd, "pw_bn", bp.get("pw_norm"), _sub(bs, "pw_norm"), norm, bcfg.dim)
    return sd


def generator_state_dict(params: Dict, cfg: InceptionGeneratorConfig,
                         stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's ``InceptionGenerator`` state_dict from a JAX generator's
    ``params`` tree and its ``batch_stats`` tree, where it has one."""
    sd: Dict[str, torch.Tensor] = {}
    trunk = ["stem"] + [f"down{j}" for j in range(len(cfg.ds_channels) - 1)]
    for j, name in enumerate(trunk):
        _conv(sd, f"down_sampling.{3 * j + 1}", params[name]["conv"])
        _norm(sd, f"down_sampling.{3 * j + 2}", params[name].get("norm"),
              _sub(stats, name, "norm"), cfg.norm, cfg.ds_channels[j])

    for i, bcfg in enumerate(cfg.blocks):
        block = inception_block_state_dict(params.get(f"block{i}", {}), bcfg, cfg.norm,
                                           _sub(stats, f"block{i}"))
        for k, v in block.items():
            sd[f"features.{i}.{k}"] = v

    for j, ch in enumerate(cfg.us_channels):
        _convt(sd, f"up_sampling.{3 * j}", params[f"up{j}_conv"])
        _norm(sd, f"up_sampling.{3 * j + 1}", params.get(f"up{j}_norm"),
              _sub(stats, f"up{j}_norm"), cfg.norm, ch)
    _conv(sd, f"up_sampling.{3 * len(cfg.us_channels) + 1}", params["head"])
    return sd


def nlayer_discriminator_state_dict(params: Dict, cfg: NLayerDiscriminatorConfig,
                                    stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's ``NLayerDiscriminator`` state_dict (``model.{i}``) from a
    JAX NLayer discriminator's ``params`` tree and its statistics."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "model.0", params["conv0"])
    for n in range(1, cfg.n_layers + 1):
        _conv(sd, f"model.{3 * n - 1}", params[f"conv{n}"])
        _norm(sd, f"model.{3 * n}", params.get(f"norm{n}"), _sub(stats, f"norm{n}"), cfg.norm,
              cfg.ndf * min(2 ** n, 8))
    _conv(sd, f"model.{3 * cfg.n_layers + 2}", params["conv_out"])
    return sd


def pixel_discriminator_state_dict(params: Dict, cfg: PixelDiscriminatorConfig,
                                   stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's ``PixelDiscriminator`` state_dict (``net.{i}``) from a JAX
    pixel discriminator's ``params`` tree and its statistics."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "net.0", params["conv0"])
    _conv(sd, "net.2", params["conv1"])
    _norm(sd, "net.3", params.get("norm1"), _sub(stats, "norm1"), cfg.norm, cfg.ndf * 2)
    _conv(sd, "net.5", params["conv_out"])
    return sd


def discriminator_net_state_dict(tree: Dict, cfg) -> Dict[str, torch.Tensor]:
    """A D checkpoint of the JAX package's train verb: ``{"params": ...}``
    with the statistics of each norm beside it (``{"params", "norm1", ...}``,
    as its ``save_fn`` spreads them)."""
    stats = {k: v for k, v in tree.items() if k != "params"}
    if isinstance(cfg, PixelDiscriminatorConfig):
        return pixel_discriminator_state_dict(tree["params"], cfg, stats)
    return nlayer_discriminator_state_dict(tree["params"], cfg, stats)


def adaptor_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's adaptor state_dict (``A{i}.weight`` / ``A{i}.bias``, 1x1
    convs) from the JAX distiller's adaptor params ``{"A{i}": {"conv": ...}}``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _conv(sd, name, p["conv"])
    return sd


def _net_state(ns: Dict, convert, params_key=None) -> Dict:
    """A JAX ``NetState`` (params, Adam state, stats) in the port's layout;
    ``convert(tree, stats)`` maps one parameter tree, ``params_key`` picks a
    group of the distiller's {G, A} tree."""
    pick = (lambda t: t[params_key]) if params_key else (lambda t: t)
    opt = ns["opt_state"]
    return {"params": convert(pick(ns["params"]), ns.get("stats") or None),
            "opt": {"count": int(np.asarray(opt["count"])),
                    "mu": convert(pick(opt["mu"]), None), "nu": convert(pick(opt["nu"]), None)}}


def _stats_only(sd: Dict) -> Dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def _split_stats(ns: Dict) -> Dict:
    """Move the running statistics out of the converted parameters (the
    converters emit whole state_dicts) and drop them from the moments."""
    params = ns["params"]
    stats = _stats_only(params)
    out = {"params": {k: v for k, v in params.items() if k not in stats}, "stats": stats,
           "opt": dict(ns["opt"])}
    for m in ("mu", "nu"):
        out["opt"][m] = {k: v for k, v in ns["opt"][m].items() if k not in stats}
    return out


def distill_state_dict(tree: Dict, student_cfg: InceptionGeneratorConfig,
                       disc_cfg: NLayerDiscriminatorConfig, adaptors: bool) -> Dict:
    """The port's train-state dict (``train/common.py::train_state_dict``'s
    layout) from the JAX distiller's full state tree (a ``<tag>_state.msgpack``
    as ``checkpoint.read_msgpack`` returns it): parameters, running
    statistics, Adam moments and counts, step and EMA.  Adam moments take
    the parameters' layout changes.  ``adaptors``: keep the adaptor group
    (the port has one only for mse).  The dropout RNG does not carry over: a
    JAX key is no torch.Generator."""
    g, d = tree["g"], tree["d"]
    extra = tree.get("extra") or {}
    g_state = _split_stats(_net_state(
        g, lambda t, s: generator_state_dict(t, student_cfg, s), "G"))
    if adaptors:
        for k in ("mu", "nu"):
            a = adaptor_state_dict(g["opt_state"][k].get("A") or {})
            g_state["opt"][k].update({f"A.{n}": v for n, v in a.items()})
    ema = {}
    if "ema_G" in extra:
        ema = {"ema_G": {k: v for k, v in generator_state_dict(extra["ema_G"], student_cfg).items()
                         if k in g_state["params"]}}
    return {
        "step": int(np.asarray(tree["step"])),
        "g": g_state,
        "d": _split_stats(_net_state(
            d, lambda t, s: nlayer_discriminator_state_dict(t, disc_cfg, s))),
        "adaptors": adaptor_state_dict(g["params"].get("A") or {}) if adaptors else {},
        "extra": ema,
    }


def _prefixed(group: Dict[str, Dict]) -> Dict:
    """``{"A": ns_A, "B": ns_B}`` of converted net states as one net state
    whose names carry the ``A.``/``B.`` prefix of the port's ``ModuleDict``."""
    out = {"params": {}, "stats": {}, "opt": {"count": None, "mu": {}, "nu": {}}}
    for name, ns in group.items():
        for k in ("params", "stats"):
            out[k].update({f"{name}.{n}": v for n, v in ns[k].items()})
        for m in ("mu", "nu"):
            out["opt"][m].update({f"{name}.{n}": v for n, v in ns["opt"][m].items()})
        out["opt"]["count"] = ns["opt"]["count"]
    return out


def train_state_dict(tree: Dict, model: str, gen_cfg: InceptionGeneratorConfig,
                     disc_cfg) -> Dict:
    """The port's train-state dict from a JAX pix2pix (``model`` "pix2pix")
    or CycleGAN ("cycle_gan") task's ``<tag>_state.msgpack``: parameters,
    running statistics, Adam moments and counts, step and, for CycleGAN,
    the image pools (their draws' generator stays seeded).  The RNG does not
    carry over."""
    def gen(t, s):
        return generator_state_dict(t, gen_cfg, s)

    def disc(t, s):
        return (pixel_discriminator_state_dict if isinstance(disc_cfg, PixelDiscriminatorConfig)
                else nlayer_discriminator_state_dict)(t, disc_cfg, s)

    g, d = tree["g"], tree["d"]
    out = {"step": int(np.asarray(tree["step"])), "adaptors": {}, "extra": {}, "pools": {}}
    if model == "pix2pix":
        out["g"] = _split_stats(_net_state(g, gen))
        out["d"] = _split_stats(_net_state(d, disc))
        return out

    def per_net(ns, convert):  # {"A": tree, "B": tree} in params, stats and moments
        opt = ns["opt_state"]
        return _prefixed({name: _split_stats(_net_state(
            {"params": ns["params"][name], "stats": (ns.get("stats") or {}).get(name),
             "opt_state": {**opt, "mu": opt["mu"][name], "nu": opt["nu"][name]}}, convert))
            for name in ("A", "B")})

    out["g"], out["d"] = per_net(g, gen), per_net(d, disc)
    for name, pool in (tree.get("extra") or {}).items():
        out["pools"][name] = {"buffer": _t(np.asarray(pool["buffer"]).transpose(0, 3, 1, 2)),
                              "count": int(np.asarray(pool["count"]))}
    return out
