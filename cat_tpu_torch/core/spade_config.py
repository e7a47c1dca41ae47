"""SPADE (GauGAN) architecture configs (a copy of
``cat_tpu/core/spade_config.py``: the same classes and fields, so JSON
written by either package loads in the other).

Reference: models/modules/inception_modules.py:345-769
(SPADEInvertedResidualChannels + InceptionSPADE) and
inception_architecture/inception_spade_generator.py.

Channel semantics mirror the reference:
  * block branch widths default to min(fin, fout) // reduction_factor,
  * SPADE (γ/β-producing) branch widths default to 128 // reduction_factor,
  * explicit ``--channels`` are divided by the reduction factor,
  * a pruned model is just different width tuples (zeros = absent branch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from cat_tpu_torch.core.config import register_config


@dataclass(frozen=True)
class SPADELayerConfig:
    """InceptionSPADE: γ/β from a multi-branch inception net over the segmap."""

    norm_nc: int  # channels being normalised (γ/β width)
    label_nc: int  # segmap channels
    res_channels: Tuple[int, ...] = ()
    dw_channels: Tuple[int, ...] = ()
    res_kernels: Tuple[int, ...] = ()
    dw_kernels: Tuple[int, ...] = ()
    param_free_norm: str = "syncbatch"  # syncbatch | batch | instance

    @property
    def active_res(self):
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.res_channels, self.res_kernels))
            if c > 0
        )

    @property
    def active_dw(self):
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.dw_channels, self.dw_kernels))
            if c > 0
        )

    @property
    def is_empty(self):
        return not self.active_res and not self.active_dw


@dataclass(frozen=True)
class SPADEBlockConfig:
    fin: int
    fout: int
    res_channels: Tuple[int, ...] = ()
    dw_channels: Tuple[int, ...] = ()
    res_kernels: Tuple[int, ...] = ()
    dw_kernels: Tuple[int, ...] = ()
    spade: SPADELayerConfig = None  # type: ignore[assignment]
    spectral: bool = False

    @property
    def learned_shortcut(self) -> bool:
        return self.fin != self.fout

    @property
    def active_res(self):
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.res_channels, self.res_kernels))
            if c > 0
        )

    @property
    def active_dw(self):
        return tuple(
            (i, c, k)
            for i, (c, k) in enumerate(zip(self.dw_channels, self.dw_kernels))
            if c > 0
        )

    @property
    def is_empty(self):
        return not self.active_res and not self.active_dw


# block order in the generator (reference inception_spade_generator.py:27-41)
def spade_block_names(num_upsampling_layers: str) -> Tuple[str, ...]:
    names = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3")
    if num_upsampling_layers == "most":
        names = names + ("up_4",)
    return names


@dataclass(frozen=True)
class SPADEGeneratorConfig:
    semantic_nc: int = 36
    output_nc: int = 3
    fc_channels: int = 1024  # 16 * ngf; the prunable trunk width
    num_upsampling_layers: str = "more"  # normal | more | most
    crop_size: int = 512
    aspect_ratio: float = 2.0
    blocks: Tuple[SPADEBlockConfig, ...] = ()
    param_free_norm: str = "syncbatch"
    spectral: bool = False
    active_fn: str = "leaky_relu"  # applied after each block's SPADE
    norm_momentum: float = 0.1
    norm_epsilon: float = 1e-5

    @property
    def block_names(self) -> Tuple[str, ...]:
        return spade_block_names(self.num_upsampling_layers)

    @property
    def ngf(self) -> int:
        return self.fc_channels // 16

    def latent_size(self) -> Tuple[int, int]:
        """(sh, sw) of the latent segmap (reference :47-61)."""
        num_up = {"normal": 5, "more": 6, "most": 7}[self.num_upsampling_layers]
        sw = self.crop_size // (2 ** num_up)
        sh = round(sw / self.aspect_ratio)
        if sw < 1 or sh < 1:
            raise ValueError(
                f"crop_size {self.crop_size} too small for "
                f"num_upsampling_layers={self.num_upsampling_layers!r} "
                f"(latent would be {sh}x{sw})"
            )
        return sh, sw

    @staticmethod
    def make(
        semantic_nc: int = 36,
        ngf: int = 64,
        channels: Optional[Tuple[int, ...]] = None,
        channels_reduction_factor: int = 1,
        kernel_sizes: Tuple[int, ...] = (3, 5, 7),
        num_upsampling_layers: str = "more",
        crop_size: int = 512,
        aspect_ratio: float = 2.0,
        param_free_norm: str = "syncbatch",
        spectral: bool = False,
        active_fn: str = "leaky_relu",
        nhidden: int = 128,
    ) -> "SPADEGeneratorConfig":
        names = spade_block_names(num_upsampling_layers)
        fc = 16 * ngf
        fins = {"head_0": fc, "G_middle_0": fc, "G_middle_1": fc}
        fouts = {"head_0": fc, "G_middle_0": fc, "G_middle_1": fc}
        f = fc
        for i in range(5):
            name = f"up_{i}"
            if name not in names:
                continue
            fins[name] = f
            f = f // 2
            fouts[name] = f

        def widths(base):
            if channels is None:
                return tuple(base // channels_reduction_factor for _ in kernel_sizes)
            if isinstance(channels, int):
                return tuple(channels // channels_reduction_factor for _ in kernel_sizes)
            return tuple(c // channels_reduction_factor for c in channels)

        blocks = []
        for name in names:
            fin, fout = fins[name], fouts[name]
            fmiddle = min(fin, fout)
            blocks.append(
                SPADEBlockConfig(
                    fin=fin,
                    fout=fout,
                    res_channels=widths(fmiddle),
                    dw_channels=widths(fmiddle),
                    res_kernels=tuple(kernel_sizes),
                    dw_kernels=tuple(kernel_sizes),
                    spade=SPADELayerConfig(
                        norm_nc=fin,
                        label_nc=semantic_nc,
                        res_channels=widths(nhidden),
                        dw_channels=widths(nhidden),
                        res_kernels=tuple(kernel_sizes),
                        dw_kernels=tuple(kernel_sizes),
                        param_free_norm=param_free_norm,
                    ),
                    spectral=spectral,
                )
            )
        return SPADEGeneratorConfig(
            semantic_nc=semantic_nc,
            fc_channels=fc,
            num_upsampling_layers=num_upsampling_layers,
            crop_size=crop_size,
            aspect_ratio=aspect_ratio,
            blocks=tuple(blocks),
            param_free_norm=param_free_norm,
            spectral=spectral,
            active_fn=active_fn,
        )


@dataclass(frozen=True)
class MultiscaleDiscriminatorConfig:
    """SPADE multiscale D (reference discriminators.py:129-226)."""

    input_nc: int = 39  # semantic_nc + output_nc
    ndf: int = 64
    n_layers: int = 4
    num_D: int = 2
    norm_D: str = "spectralinstance"


for _cls in (
    SPADELayerConfig,
    SPADEBlockConfig,
    SPADEGeneratorConfig,
    MultiscaleDiscriminatorConfig,
):
    register_config(_cls)
