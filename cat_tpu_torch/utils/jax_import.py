"""Carry weights of the JAX package into the port.

A JAX generator (inception, SPADE or the UNet), NLayer-, pixel- or
multiscale discriminator, DRN or DeepLab v2 judge or distillation-adaptor
(the distillers' and ``GenericDistiller``'s) parameter tree, given as
nested dicts of numpy arrays (``variables["params"]``, as
``utils/checkpoint.py::read_msgpack`` returns it from a ``.msgpack`` file),
with its batch-norm statistics tree (``variables["batch_stats"]``, the same
paths as the parameters), becomes the port's state_dict in the reference CAT
key layout, so ``cat_tpu/utils/torch_import.py::import_inception_generator``
carries the port's generator weights back unchanged (and
``cat_tpu/utils/spade_import.py::import_spade_generator`` a SPADE
generator's).  So do whole train states of the JAX distillers (inception
and SPADE) and of the pix2pix, CycleGAN and SPADE tasks.

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
  spectral   kernel / bias -> weight_orig / bias; the ``spectral``
             collection's u -> weight_u, and weight_v = l2norm(Wᵀu)
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
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var", "weight_u", "weight_v"))}


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
    """The port's train-state dict from a JAX pix2pix (``model`` "pix2pix"),
    CycleGAN ("cycle_gan") or SPADE ("spade") task's
    ``<tag>_state.msgpack``: parameters, running statistics and spectral
    vectors, Adam moments and counts, step and, for CycleGAN, the image
    pools (their draws' generator stays seeded).  The RNG does not carry
    over."""
    def gen(t, s):
        return generator_state_dict(t, gen_cfg, s)

    def disc(t, s):
        return (pixel_discriminator_state_dict if isinstance(disc_cfg, PixelDiscriminatorConfig)
                else nlayer_discriminator_state_dict)(t, disc_cfg, s)

    if model == "spade":
        def gen(t, s):
            return spade_generator_state_dict(t, gen_cfg, s)

        def disc(t, s):
            return multiscale_discriminator_state_dict(t, disc_cfg, s)

    g, d = tree["g"], tree["d"]
    out = {"step": int(np.asarray(tree["step"])), "adaptors": {}, "extra": {}, "pools": {}}
    if model in ("pix2pix", "spade"):
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


def drnseg_state_dict(tree: Dict, layers) -> Dict[str, torch.Tensor]:
    """The port's ``DRNSeg`` state_dict (the reference checkpoint's layout)
    from a JAX ``DRNSeg``'s variables ``{"params": ...}`` (its frozen batch
    norms keep their statistics as parameters ``bn_mean``/``bn_var``); the
    inverse of ``cat_tpu/metrics/drn.py::convert_torch_drnseg``."""
    params = tree["params"]
    base = params["base"]
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(conv_key, bn_key, kernel, bn):
        sd[f"{conv_key}.weight"] = _t(np.asarray(kernel).transpose(3, 2, 0, 1))
        for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"),
                             ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            sd[f"{bn_key}.{ours}"] = _t(bn[theirs])
        sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0)

    conv_bn("base.0.0", "base.0.1", base["layer0_conv"]["kernel"], base["layer0_bn"])
    for li in (1, 2, 7, 8):
        for i in range(layers[li - 1]):
            p = base[f"layer{li}_conv{i}"]
            conv_bn(f"base.{li}.{3 * i}", f"base.{li}.{3 * i + 1}", p["conv"]["kernel"],
                    p["bn"])
    for li in (3, 4, 5, 6):
        for b in range(layers[li - 1]):
            p, key = base[f"layer{li}_block{b}"], f"base.{li}.{b}"
            for ci in (1, 2, 3):
                conv_bn(f"{key}.conv{ci}", f"{key}.bn{ci}", p[f"c{ci}"]["conv"]["kernel"],
                        p[f"c{ci}"]["bn"])
            if "down" in p:
                conv_bn(f"{key}.downsample.0", f"{key}.downsample.1", p["down"]["conv"]["kernel"],
                        p["down"]["bn"])
    _conv(sd, "seg", params["seg"])
    return sd


# ---------------------------------------------------------------------------
# SPADE
# ---------------------------------------------------------------------------


def _sconv(sd: Dict, key: str, p: Dict, spectral: bool, u=None) -> None:
    """A conv, spectrally normalised where ``spectral`` (torch's
    spectral_norm names; ``u`` where the tree has it)."""
    if not spectral:
        _conv(sd, key, p)
        return
    w = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
    sd[f"{key}.weight_orig"] = _t(w)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])
    if u is not None:
        u = np.asarray(u, np.float32)
        v = w.reshape(w.shape[0], -1).T @ u
        sd[f"{key}.weight_u"] = _t(u)
        sd[f"{key}.weight_v"] = _t(v / (np.linalg.norm(v) + 1e-12))


def spade_generator_state_dict(params: Dict, cfg, stats: Optional[Dict] = None
                               ) -> Dict[str, torch.Tensor]:
    """The port's ``SPADEGenerator`` state_dict (the reference's layout)
    from a JAX SPADE generator's ``params`` and its state collections
    ``stats`` (``{"batch_stats": ..., "spectral": ...}``, either may be
    absent); the inverse of ``cat_tpu/utils/spade_import.py::import_spade_generator``.
    Branches are numbered by position among those that exist."""
    from cat_tpu_torch.models.spade import _norm_cfg

    bs = (stats or {}).get("batch_stats")
    sp = (stats or {}).get("spectral")
    sd: Dict[str, torch.Tensor] = {}
    free = _norm_cfg(cfg.param_free_norm, affine=False)
    affine = _norm_cfg(cfg.param_free_norm, affine=True)
    branch = _norm_cfg("syncbatch", affine=True)
    _conv(sd, "fc", params["fc"])
    _norm(sd, "fc_norm", params.get("fc_norm"), _sub(bs, "fc_norm"), affine, cfg.fc_channels)
    for name, bcfg in zip(cfg.block_names, cfg.blocks):
        p, spectral = params.get(name, {}), bcfg.spectral

        def cna(key, mod, norm, ch, scope=(name,)):
            _sconv(sd, f"{key}.conv", _sub(p, *scope[1:], mod, "conv"), spectral and
                   len(scope) == 1, _sub(sp, *scope, mod, "conv", "u"))
            _norm(sd, f"{key}.norm", _sub(p, *scope[1:], mod, "norm"),
                  _sub(bs, *scope, mod, "norm"), norm, ch)

        def out(key, mod):
            _sconv(sd, f"{key}.conv", p[mod]["conv"], spectral, _sub(sp, name, mod, "conv", "u"))

        for pos, (b, mid, _) in enumerate(bcfg.active_res):
            cna(f"{name}.res_ops.{pos}.0", f"res{b}_in", affine, mid)
            out(f"{name}.res_ops.{pos}.1", f"res{b}_out")
        for pos, (b, mid, _) in enumerate(bcfg.active_dw):
            cna(f"{name}.dw_ops.{pos}.0", f"dw{b}_in", affine, mid)
            cna(f"{name}.dw_ops.{pos}.1", f"dw{b}_mid", free, mid)
            out(f"{name}.dw_ops.{pos}.2", f"dw{b}_out")
        if bcfg.learned_shortcut:
            _norm(sd, f"{name}.shortcut.0", p.get("shortcut_norm"),
                  _sub(bs, name, "shortcut_norm"), affine, bcfg.fin)
            out(f"{name}.shortcut.1", "shortcut_conv")
        if bcfg.is_empty:
            continue
        scfg, key = bcfg.spade, f"{name}.spade"
        _norm(sd, f"{key}.param_free_norm", None, _sub(bs, name, "spade", "param_free_norm"),
              _norm_cfg(scfg.param_free_norm, affine=False), scfg.norm_nc)
        scope = (name, "spade")
        for pos, (b, mid, _) in enumerate(scfg.active_res):
            cna(f"{key}.res_ops.{pos}.0", f"res{b}_in", branch, mid, scope)
            _conv(sd, f"{key}.res_ops.{pos}.1", p["spade"][f"res{b}_out"])
        for pos, (b, mid, _) in enumerate(scfg.active_dw):
            cna(f"{key}.dw_ops.{pos}.0", f"dw{b}_in", branch, mid, scope)
            cna(f"{key}.dw_ops.{pos}.1", f"dw{b}_mid", branch, mid, scope)
            _conv(sd, f"{key}.dw_ops.{pos}.2", p["spade"][f"dw{b}_out"])
    _conv(sd, "conv_img", params["conv_img"])
    return sd


def multiscale_discriminator_state_dict(params: Dict, cfg, stats: Optional[Dict] = None
                                        ) -> Dict[str, torch.Tensor]:
    """The port's ``MultiscaleDiscriminator`` state_dict from a JAX one's
    ``params`` and state collections (``{"spectral": {...}}`` holds each
    spectral conv's ``u``)."""
    sp = (stats or {}).get("spectral")
    spectral = cfg.norm_D.startswith("spectral")
    nested = (cfg.norm_D.replace("spectral", "") or "instance") != "none"
    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_D):
        p, pre = params[f"discriminator_{i}"], f"discriminator_{i}"
        _conv(sd, f"{pre}.model0.0", p["layer0_conv"])
        for n in range(1, cfg.n_layers):
            _sconv(sd, f"{pre}.model{n}.0" + (".0" if nested else ""), p[f"layer{n}_conv"],
                   spectral, _sub(sp, pre, f"layer{n}_conv", "u"))
        _conv(sd, f"{pre}.model{cfg.n_layers}.0", p["layer_out_conv"])
    return sd


def spade_net_state_dict(tree: Dict, cfg) -> Dict[str, torch.Tensor]:
    """A SPADE G or D checkpoint of the JAX package's train verb:
    ``{"params": ..., "batch_stats": ..., "spectral": ...}``, as its
    ``save_fn`` spreads a net's state collections beside its parameters."""
    stats = {k: v for k, v in tree.items() if k != "params"}
    if hasattr(cfg, "num_D"):
        return multiscale_discriminator_state_dict(tree["params"], cfg, stats)
    return spade_generator_state_dict(tree["params"], cfg, stats)


def spade_distill_state_dict(tree: Dict, student_cfg, disc_cfg) -> Dict:
    """The port's train-state dict from the JAX SPADE distiller's full state
    tree (a ``<tag>_state.msgpack`` as ``checkpoint.read_msgpack`` returns
    it): the student G and the adaptors ``A`` (one Adam state over both),
    D with its spectral ``u``, the running statistics, both Adam states,
    the step and the EMA.  The RNG does not carry over."""
    g, d = tree["g"], tree["d"]
    extra = tree.get("extra") or {}
    g_state = _split_stats(_net_state(
        g, lambda t, s: spade_generator_state_dict(t, student_cfg, s), "G"))
    for k in ("mu", "nu"):
        a = adaptor_state_dict(g["opt_state"][k].get("A") or {})
        g_state["opt"][k].update({f"A.{n}": v for n, v in a.items()})
    ema = {}
    if "ema_G" in extra:
        ema = {"ema_G": {k: v for k, v in spade_generator_state_dict(
            extra["ema_G"], student_cfg).items() if k in g_state["params"]}}
    return {
        "step": int(np.asarray(tree["step"])),
        "g": g_state,
        "d": _split_stats(_net_state(
            d, lambda t, s: multiscale_discriminator_state_dict(t, disc_cfg, s))),
        "adaptors": adaptor_state_dict(g["params"].get("A") or {}),
        "extra": ema,
    }


# ---------------------------------------------------------------------------
# The UNet family and DeepLab v2
# ---------------------------------------------------------------------------


def unet_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``models/unet.py::UNet`` state_dict from a JAX ``UNet``'s
    params (the same module names): a conv's HWIO kernel -> OIHW, a Dense
    kernel (in, out) -> weight (out, in), a GroupNorm's scale -> weight."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        if "kernel" in tree:
            k = np.asarray(tree["kernel"])
            sd[f"{prefix}.weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T)
            sd[f"{prefix}.bias"] = _t(tree["bias"])
        elif "scale" in tree:
            sd[f"{prefix}.weight"] = _t(tree["scale"])
            sd[f"{prefix}.bias"] = _t(tree["bias"])
        else:
            for name, sub in tree.items():
                walk(sub, f"{prefix}.{name}" if prefix else name)

    walk(params, "")
    return sd


def deeplabv2_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``metrics/deeplabv2.py::DeepLabV2`` state_dict (the
    reference checkpoint's layout) from a JAX ``DeepLabV2``'s params (its
    frozen batch norms keep their statistics as ``bn_mean``/``bn_var``); the
    inverse of ``cat_tpu/metrics/deeplabv2.py::convert_torch_deeplabv2``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        if "bn_mean" in tree:
            for ours, theirs in (("weight", "bn_scale"), ("bias", "bn_bias"),
                                 ("running_mean", "bn_mean"), ("running_var", "bn_var")):
                sd[f"{prefix}.{ours}"] = _t(tree[theirs])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        elif "kernel" in tree:
            _conv(sd, prefix, tree)
        else:
            for name, sub in tree.items():
                walk(sub, f"{prefix}.{name}" if prefix else name)

    walk(params, "")
    return sd
