"""Architecture configs.

The architecture is an explicit, immutable, JSON-serialisable dataclass:
pruning emits a *new* config, and checkpoints store the config next to the
parameters.  Module construction, analytic MAC profiling, pruning and weight
slicing are pure functions of a config.

The class names and fields are those of the JAX package's configs, so JSON
written by either package loads in the other (``config_to_json`` /
``config_from_json``).

Channel-count semantics match the reference CAT exactly:

* ``InceptionBlockConfig.res_channels[i]`` is the *final* mid-channel width of
  the i-th residual branch (``--channels`` divided by
  ``--channels_reduction_factor``).
* A branch whose width is 0 does not exist.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

NORM_KINDS = ("instance", "batch", "syncbatch", "none")


@dataclass(frozen=True)
class NormConfig:
    """Normalisation-layer spec (reference: models/networks.py:29-64)."""

    kind: str = "instance"
    affine: bool = True
    track_running_stats: bool = False
    momentum: float = 0.1
    eps: float = 1e-5

    def __post_init__(self):
        if self.kind not in NORM_KINDS:
            raise ValueError(f"unknown norm kind {self.kind!r}")

    @property
    def is_batch_like(self) -> bool:
        return self.kind in ("batch", "syncbatch")

    @property
    def has_scale(self) -> bool:
        return self.affine and self.kind != "none"


@dataclass(frozen=True)
class InceptionBlockConfig:
    """One multi-branch inverted-residual block.

    Residual branches: pad -> conv(k) -> norm -> act -> dropout -> pad ->
    conv(k) back to ``dim``.  Depthwise branches: conv(1x1) -> norm -> act ->
    pad -> depthwise conv(k) -> norm -> act -> dropout -> conv(1x1) back to
    ``dim``.  Output = x + pw_norm(sum of all branches).
    """

    dim: int
    res_channels: Tuple[int, ...] = ()
    dw_channels: Tuple[int, ...] = ()
    res_kernels: Tuple[int, ...] = ()
    dw_kernels: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.res_channels) != len(self.res_kernels):
            raise ValueError("res_channels and res_kernels length mismatch")
        if len(self.dw_channels) != len(self.dw_kernels):
            raise ValueError("dw_channels and dw_kernels length mismatch")

    @property
    def active_res(self) -> Tuple[Tuple[int, int, int], ...]:
        """(branch_index, mid_channels, kernel) for branches that exist."""
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.res_channels, self.res_kernels))
            if c > 0
        )

    @property
    def active_dw(self) -> Tuple[Tuple[int, int, int], ...]:
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.dw_channels, self.dw_kernels))
            if c > 0
        )

    @property
    def is_empty(self) -> bool:
        return not self.active_res and not self.active_dw


@dataclass(frozen=True)
class InceptionGeneratorConfig:
    """``inception_9blocks`` generator.

    Structure: ReflectPad(3) + 7x7 conv -> ds_channels[0], then
    len(ds_channels)-1 stride-2 3x3 convs; ``blocks`` inverted-residual
    blocks at ds_channels[-1]; then len(us_channels) stride-2 transposed
    convs -> us_channels[i]; ReflectPad(3) + 7x7 conv -> output_nc; tanh.
    Every conv except the output conv is followed by norm + activation.
    """

    input_nc: int = 3
    output_nc: int = 3
    ds_channels: Tuple[int, ...] = (64, 128, 256)
    us_channels: Tuple[int, ...] = (128, 64)
    blocks: Tuple[InceptionBlockConfig, ...] = ()
    norm: NormConfig = NormConfig()
    padding_type: str = "reflect"  # reflect | replicate | zero
    active_fn: str = "relu"  # relu | relu6 | leaky_relu
    dropout_rate: float = 0.0

    def __post_init__(self):
        for b in self.blocks:
            if b.dim != self.ds_channels[-1]:
                raise ValueError(
                    f"block dim {b.dim} != bottleneck width {self.ds_channels[-1]}"
                )

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def bottleneck(self) -> int:
        return self.ds_channels[-1]

    @staticmethod
    def make(
        input_nc: int = 3,
        output_nc: int = 3,
        ngf: int = 64,
        channels: Optional[Tuple[int, ...]] = None,
        channels_reduction_factor: int = 1,
        kernel_sizes: Tuple[int, ...] = (3, 5, 7),
        n_blocks: int = 9,
        norm: NormConfig = NormConfig(),
        padding_type: str = "reflect",
        active_fn: str = "relu",
        dropout_rate: float = 0.0,
    ) -> "InceptionGeneratorConfig":
        """Uniform (teacher) generator, mirroring the reference defaults.

        With ``channels=None`` each branch's mid width is
        ``(4*ngf) // channels_reduction_factor``; with an int/sequence it is
        ``channels[i] // channels_reduction_factor``.
        """
        if len(set(kernel_sizes)) != len(kernel_sizes):
            raise ValueError("duplicate kernel sizes are not allowed")
        bottleneck = ngf * 4
        if channels is None:
            mids = tuple(bottleneck // channels_reduction_factor for _ in kernel_sizes)
        elif isinstance(channels, int):
            mids = tuple(channels // channels_reduction_factor for _ in kernel_sizes)
        else:
            if len(channels) != len(kernel_sizes):
                raise ValueError("channels and kernel_sizes length mismatch")
            mids = tuple(c // channels_reduction_factor for c in channels)
        block = InceptionBlockConfig(
            dim=bottleneck,
            res_channels=mids,
            dw_channels=mids,
            res_kernels=tuple(kernel_sizes),
            dw_kernels=tuple(kernel_sizes),
        )
        return InceptionGeneratorConfig(
            input_nc=input_nc,
            output_nc=output_nc,
            ds_channels=(ngf, ngf * 2, ngf * 4),
            us_channels=(ngf * 2, ngf),
            blocks=tuple(block for _ in range(n_blocks)),
            norm=norm,
            padding_type=padding_type,
            active_fn=active_fn,
            dropout_rate=dropout_rate,
        )


@dataclass(frozen=True)
class NLayerDiscriminatorConfig:
    """70x70 PatchGAN (reference: models/modules/discriminators.py:14-79)."""

    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3
    norm: NormConfig = NormConfig(kind="instance", affine=False)
    active_fn: str = "leaky_relu"


@dataclass(frozen=True)
class PixelDiscriminatorConfig:
    """1x1 PixelGAN (reference: discriminators.py:82-126)."""

    input_nc: int = 3
    ndf: int = 64
    norm: NormConfig = NormConfig(kind="instance", affine=False)
    active_fn: str = "leaky_relu"


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------

_CONFIG_TYPES = {
    cls.__name__: cls
    for cls in (
        NormConfig,
        InceptionBlockConfig,
        InceptionGeneratorConfig,
        NLayerDiscriminatorConfig,
        PixelDiscriminatorConfig,
    )
}


def register_config(cls):
    """Make a config class of another module round-trip through
    ``config_to_json``/``config_from_json`` (``core/spade_config.py``, which
    ``core/__init__.py`` imports)."""
    _CONFIG_TYPES[cls.__name__] = cls
    return cls


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = _to_dict(getattr(obj, f.name))
        return d
    if isinstance(obj, (tuple, list)):
        return [_to_dict(x) for x in obj]
    return obj


def _from_dict(d: Any) -> Any:
    if isinstance(d, dict) and "__type__" in d:
        cls = _CONFIG_TYPES.get(d["__type__"])
        if cls is None:
            raise ValueError(f"config type {d['__type__']!r} is not ported yet")
        kwargs = {f.name: _from_dict(d[f.name]) for f in dataclasses.fields(cls)
                  if f.name in d}
        return cls(**kwargs)
    if isinstance(d, list):
        return tuple(_from_dict(x) for x in d)
    return d


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_dict(cfg), indent=2)


def config_from_json(s: str) -> Any:
    return _from_dict(json.loads(s))
