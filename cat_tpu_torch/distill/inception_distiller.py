"""Inception (ResNet-generator) distiller: the CAT KA-distillation step
(port of ``cat_tpu/distill/inception_distiller.py``).

One ``train_step`` does what the JAX package's ``_step`` does:

  * the frozen teacher runs in eval mode and returns its taps;
  * the student runs forward once and its graph is kept;
  * D updates first, on the detached fake (0.5·(fake + real) GAN loss);
  * the G loss goes through the *updated* D, and only the student's
    parameters take its gradient;
  * G loss = GAN + λ_recon · recon (target: the teacher's output when
    unaligned) + λ_distill · Σ_taps -KA(student tap, teacher tap).

Mixed precision follows the JAX placement, not ``torch.autocast``: float32
masters; parameters and inputs cast to the compute dtype inside the forward
(``down``), so autograd brings float32 gradients back; norm statistics in
float32; network outputs cast to float32 for the losses (``up``).  KA takes
the taps in the compute dtype.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
from cat_tpu_torch.distill.ka import ka
from cat_tpu_torch.models.discriminators import NLayerDiscriminator
from cat_tpu_torch.models.generator import DEFAULT_MAPPING_LAYERS, InceptionGenerator
from cat_tpu_torch.models.losses import gan_loss, recon_loss
from cat_tpu_torch.train.common import GANTrainState, NetState, cast_floats
from cat_tpu_torch.train.optim import Adam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DistillHParams:
    dataset_mode: str = "aligned"  # aligned | unaligned
    gan_mode: str = "hinge"
    recon_loss_type: str = "l1"
    distill_loss_type: str = "ka"  # ka (mse is not ported yet)
    lambda_gan: float = 1.0
    lambda_recon: float = 100.0
    lambda_distill: float = 1.0
    beta1: float = 0.5
    init_type: str = "normal"
    init_gain: float = 0.02
    mapping_layers: Tuple[str, ...] = DEFAULT_MAPPING_LAYERS
    compute_dtype: str = "float32"  # float32 | bfloat16
    teacher_compute_dtype: str = ""  # '' follows compute_dtype (int8 not ported yet)
    fused_norms: bool = False  # affine instance norm + relu through the fused kernel
    packed_blocks: bool = True  # branch-packed inception blocks (same math)
    remat: bool = False  # not ported yet
    ema_decay: float = 0.0  # not ported yet


def _check_ported(hp: DistillHParams) -> None:
    """Raise for the hyperparameters whose code paths are not ported yet,
    naming the ROADMAP.md item that brings them."""
    for what, asked, item in (
        ("teacher_compute_dtype=int8", hp.teacher_compute_dtype.startswith("int8"), "Extras"),
        ("remat", hp.remat, "Distill verb end to end"),
        ("ema_decay>0", hp.ema_decay > 0, "Distill verb end to end"),
        ("distill_loss_type='mse'", hp.distill_loss_type == "mse", "Distill verb end to end"),
        ("gan_mode='wgangp' (gradient penalty)", hp.gan_mode == "wgangp", "Teacher training"),
    ):
        if asked:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1, '{item}'")
    if hp.distill_loss_type != "ka":
        raise NotImplementedError(hp.distill_loss_type)
    if hp.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")


class InceptionDistiller:
    def __init__(
        self,
        teacher_cfg: InceptionGeneratorConfig,
        student_cfg: InceptionGeneratorConfig,
        disc_cfg: Optional[NLayerDiscriminatorConfig] = None,
        hp: DistillHParams = DistillHParams(),
        device=None,
    ):
        _check_ported(hp)
        self.device = resolve_device(device)
        self.teacher_cfg = teacher_cfg
        self.student_cfg = student_cfg
        if disc_cfg is None:
            # aligned: D sees the (A, B) pair; unaligned: D sees B only
            d_in = (
                teacher_cfg.input_nc + teacher_cfg.output_nc
                if hp.dataset_mode == "aligned"
                else teacher_cfg.output_nc
            )
            disc_cfg = NLayerDiscriminatorConfig(input_nc=d_in, ndf=64)
        self.disc_cfg = disc_cfg
        self.hp = hp
        self.cdt = _DTYPES[hp.compute_dtype]
        self.netG_teacher: Optional[InceptionGenerator] = None
        self.netG_student: Optional[InceptionGenerator] = None
        self.netD: Optional[NLayerDiscriminator] = None

    # ------------------------------------------------------------------ state

    def _generator(self, cfg, gen) -> InceptionGenerator:
        hp = self.hp
        return InceptionGenerator(cfg, hp.init_type, hp.init_gain, fused_norms=hp.fused_norms,
                                  packed_blocks=hp.packed_blocks, generator=gen)

    def init_state(
        self,
        teacher_state_dict: Dict[str, torch.Tensor],
        student_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        disc_state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
    ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """Build the networks on the device and the train state.  The teacher
        comes from ``teacher_state_dict``; the student and D are freshly
        initialised from ``seed`` unless their state_dicts are given.
        Returns (state, teacher parameters)."""
        gen = torch.Generator().manual_seed(seed)
        teacher = self._generator(self.teacher_cfg, gen)
        teacher.load_state_dict(teacher_state_dict)
        self.netG_teacher = teacher.requires_grad_(False).to(self.device).eval()

        student = self._generator(self.student_cfg, gen)
        if student_state_dict is not None:
            student.load_state_dict(student_state_dict)
        self.netG_student = student.to(self.device)

        netD = NLayerDiscriminator(self.disc_cfg, self.hp.init_type, self.hp.init_gain,
                                   generator=gen)
        if disc_state_dict is not None:
            netD.load_state_dict(disc_state_dict)
        self.netD = netD.to(self.device)

        g_params = dict(self.netG_student.named_parameters())
        d_params = dict(self.netD.named_parameters())
        state = GANTrainState(
            step=0,
            g=NetState(g_params, Adam(g_params.values(), self.hp.beta1)),
            d=NetState(d_params, Adam(d_params.values(), self.hp.beta1)),
            rng=torch.Generator(device=self.device).manual_seed(seed),
        )
        return state, dict(self.netG_teacher.named_parameters())

    # ------------------------------------------------------------------- step

    def _distill_loss(self, s_acts, t_acts):
        losses = {}
        total = torch.zeros((), device=self.device)
        for i, name in enumerate(self.hp.mapping_layers):
            li = -ka(s_acts[name], t_acts[name])
            losses[f"Specific_loss/distill{i}"] = li
            total = total + li
        return total, losses

    def train_step(
        self,
        state: GANTrainState,
        teacher_params: Dict[str, torch.Tensor],
        batch: Dict[str, torch.Tensor],
        lr: float,
    ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One D-then-G step; updates ``state``'s parameters and optimisers in
        place and returns it with the step's losses (0-d tensors)."""
        hp = self.hp
        mixed = self.cdt != torch.float32

        def down(t):  # params / inputs -> compute dtype
            return cast_floats(t, self.cdt) if mixed else t

        def up(t):  # network outputs -> float32 for the losses
            return cast_floats(t, torch.float32) if mixed else t

        real_A = down(batch["A"])
        real_B = batch.get("B", batch["A"])
        taps = hp.mapping_layers
        aligned = hp.dataset_mode == "aligned"

        # --- teacher forward: frozen, eval mode ---
        with torch.no_grad():
            t_fake, t_acts = functional_call(
                self.netG_teacher, down(teacher_params), (real_A,),
                {"train": False, "taps": taps},
            )
        t_fake = up(t_fake)

        # --- student forward once, graph kept ---
        s_params = state.g.params
        s_fake, s_acts = functional_call(
            self.netG_student, down(s_params), (real_A,),
            {"train": True, "taps": taps, "generator": state.rng},
        )
        s_fake = up(s_fake)

        # --- discriminator update on the detached fake ---
        fake_d = down(s_fake.detach())
        if aligned:
            fake_in = torch.cat([real_A, fake_d], 1)
            real_in = torch.cat([real_A, down(real_B)], 1)
        else:
            fake_in, real_in = fake_d, down(real_B)
        d_params = state.d.params
        d_down = down(d_params)
        l_d_fake = gan_loss(up(functional_call(self.netD, d_down, (fake_in,))), False,
                            hp.gan_mode, True)
        l_d_real = gan_loss(up(functional_call(self.netD, d_down, (real_in,))), True,
                            hp.gan_mode, True)
        d_grads = torch.autograd.grad(0.5 * (l_d_fake + l_d_real), list(d_params.values()))
        state.d.opt.step(d_grads, lr)

        # --- generator update through the updated D (no gradient into D) ---
        recon_target = real_B if aligned else t_fake
        d_in = torch.cat([real_A, down(s_fake)], 1) if aligned else down(s_fake)
        d_frozen = down({k: v.detach() for k, v in d_params.items()})
        pred = functional_call(self.netD, d_frozen, (d_in,))
        l_g_gan = gan_loss(up(pred), True, hp.gan_mode, False) * hp.lambda_gan
        l_g_rec = recon_loss(s_fake, recon_target, hp.recon_loss_type) * hp.lambda_recon
        if hp.lambda_distill > 0:
            l_g_dis, dis_parts = self._distill_loss(s_acts, t_acts)
            l_g_dis = l_g_dis * hp.lambda_distill
        else:
            l_g_dis, dis_parts = torch.zeros((), device=self.device), {}
        g_grads = torch.autograd.grad(l_g_gan + l_g_rec + l_g_dis, list(s_params.values()))
        state.g.opt.step(g_grads, lr)

        state.step += 1
        metrics = {
            "G_loss/gan": l_g_gan,
            "G_loss/recon": l_g_rec,
            "G_loss/distill": l_g_dis,
            "D_loss/fake": l_d_fake,
            "D_loss/real": l_d_real,
            **dis_parts,
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    # -------------------------------------------------------------- inference

    @torch.no_grad()
    def generate_student(self, state: GANTrainState, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_student, state.g.params, (x,))

    @torch.no_grad()
    def generate_teacher(self, teacher_params: Dict[str, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_teacher, teacher_params, (x,))
