"""Analytic MAC / parameter profiling — pure shape arithmetic over configs.

The reference counts MACs by instrumenting every module with forward hooks
and running a real forward pass (utils/model_profiling.py:65-346), so its
pruning binary search pays a model rebuild + device forward per iteration.
Here the count is a closed-form function of the architecture config, so the
whole FLOPs search runs on host in microseconds.

Formulas replicate the reference exactly (MACs, batch=1):
  Conv2d / ConvTranspose2d: Cin*Cout*Kh*Kw*Hout*Wout / groups
    (model_profiling.py:87-100 — note the reference uses *output* spatial
    size for transposed convs too; we keep that convention for parity)
  Norm layers with track_running_stats=False: C*Hout*Wout
  Norm layers with track_running_stats=True: 0 MACs and 0 params
    (model_profiling.py:106-135 — the reference also zeroes the params of
    tracked norms; kept for parity)
  Activations / padding / dropout / tanh: 0
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from cat_tpu_torch.core.config import (
    InceptionBlockConfig,
    InceptionGeneratorConfig,
    NormConfig,
)


def conv_out_size(size: int, kernel: int, stride: int = 1, pad: int = 0) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def _conv(cin, cout, k, hout, wout, groups=1, bias=True):
    macs = cin * cout * k * k * hout * wout // groups
    params = cin * cout * k * k // groups + (cout if bias else 0)
    return macs, params


def _norm(norm: NormConfig, c, h, w):
    if norm.kind == "none" or norm.track_running_stats:
        return 0, 0
    macs = c * h * w
    params = 2 * c if norm.affine else 0
    return macs, params


@dataclass
class GeneratorProfile:
    macs: int = 0
    params: int = 0
    sections: Dict[str, int] = field(default_factory=dict)

    def add(self, section: str, macs: int, params: int):
        self.macs += macs
        self.params += params
        self.sections[section] = self.sections.get(section, 0) + macs


def profile_block(
    cfg: InceptionBlockConfig, norm: NormConfig, h: int, w: int, use_bias: bool
) -> Tuple[int, int]:
    macs = params = 0
    if cfg.is_empty:
        return 0, 0
    for _, mid, k in cfg.active_res:
        m, p = _conv(cfg.dim, mid, k, h, w, bias=use_bias)
        macs, params = macs + m, params + p
        m, p = _norm(norm, mid, h, w)
        macs, params = macs + m, params + p
        m, p = _conv(mid, cfg.dim, k, h, w, bias=use_bias)
        macs, params = macs + m, params + p
    for _, mid, k in cfg.active_dw:
        m, p = _conv(cfg.dim, mid, 1, h, w, bias=use_bias)
        macs, params = macs + m, params + p
        m, p = _norm(norm, mid, h, w)
        macs, params = macs + m, params + p
        m, p = _conv(mid, mid, k, h, w, groups=mid, bias=use_bias)
        macs, params = macs + m, params + p
        m, p = _norm(norm, mid, h, w)
        macs, params = macs + m, params + p
        m, p = _conv(mid, cfg.dim, 1, h, w, bias=use_bias)
        macs, params = macs + m, params + p
    m, p = _norm(norm, cfg.dim, h, w)
    macs, params = macs + m, params + p
    return macs, params


def profile_generator(
    cfg: InceptionGeneratorConfig, height: int, width: int
) -> GeneratorProfile:
    """MACs/params of an ``inception_9blocks`` generator at a given input size."""
    prof = GeneratorProfile()
    use_bias = cfg.norm.kind in ("instance", "none")
    h, w = height, width

    # stem: reflect-pad 3 + 7x7 valid conv keeps spatial size
    m, p = _conv(cfg.input_nc, cfg.ds_channels[0], 7, h, w, bias=use_bias)
    prof.add("down_sampling", m, p)
    m, p = _norm(cfg.norm, cfg.ds_channels[0], h, w)
    prof.add("down_sampling", m, p)

    cin = cfg.ds_channels[0]
    for ch in cfg.ds_channels[1:]:
        h, w = conv_out_size(h, 3, 2, 1), conv_out_size(w, 3, 2, 1)
        m, p = _conv(cin, ch, 3, h, w, bias=use_bias)
        prof.add("down_sampling", m, p)
        m, p = _norm(cfg.norm, ch, h, w)
        prof.add("down_sampling", m, p)
        cin = ch

    for bcfg in cfg.blocks:
        m, p = profile_block(bcfg, cfg.norm, h, w, use_bias)
        prof.add("features", m, p)

    for ch in cfg.us_channels:
        h, w = h * 2, w * 2
        m, p = _conv(cin, ch, 3, h, w, bias=use_bias)
        prof.add("up_sampling", m, p)
        m, p = _norm(cfg.norm, ch, h, w)
        prof.add("up_sampling", m, p)
        cin = ch

    m, p = _conv(cin, cfg.output_nc, 7, h, w, bias=True)
    prof.add("up_sampling", m, p)
    return prof
