"""Inception (ResNet-generator) distiller: the CAT distillation step (port
of ``cat_tpu/distill/inception_distiller.py``).

One ``train_step`` does what the JAX package's ``_step`` does:

  * the frozen teacher runs in eval mode and returns its taps;
  * the student runs forward once and its graph is kept (with ``remat``,
    only its inputs are kept and ``torch.utils.checkpoint`` recomputes the
    forward in the backward);
  * D updates first, on the detached fake (0.5·(fake + real) GAN loss,
    plus the gradient penalty under wgangp);
  * the G loss goes through the *updated* D, and only the student's
    parameters and the adaptors take its gradient;
  * G loss = GAN + λ_recon · recon (target: the teacher's output when
    unaligned) + λ_distill · Σ_taps d(student tap, teacher tap), with
    d = -KA (``ka``) or the mean squared error of a 1x1-conv adaptor of the
    student tap against the teacher tap (``mse``; one adaptor per tap,
    trained with the student by one Adam, as in the JAX package's {G, A}
    parameter group);
  * with ``ema_decay`` > 0, an exponential moving average of the student's
    weights follows every G step and is what evaluation and deployment use;
  * with ``teacher_compute_dtype`` 'int8' the teacher's convolutions run in
    int8 (``ops/quant.py``), with 'int8_static' at activation scales
    calibrated on the first batch (``ops/quant.py::teacher_forward``).

Under batch norm the forwards that move running statistics are the JAX
package's mutable ones: the student's forward and D's fake and real
forwards.  The G loss's D forward, the penalty's and a remat recompute run
under ``ops/nn.py::frozen_stats``; the teacher normalises with its own
running statistics.

Mixed precision follows the JAX placement, not ``torch.autocast``: float32
masters; parameters and inputs cast to the compute dtype inside the forward
(``down``), so autograd brings float32 gradients back; norm statistics in
float32; network outputs cast to float32 for the losses (``up``).  KA takes
the taps in the compute dtype; the mse path takes them in float32.

Over several ranks (``parallel/``) the step is the single-device step of
the global batch: each rank holds its data index's rows and, with
``--n_spatial``, its spatial index's height rows of every image; the
networks, losses and KA take the other ranks' rows and sums through their
collectives, and the parameter gradients are averaged over the world.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
from cat_tpu_torch.distill.ka import ka
from cat_tpu_torch.models.discriminators import NLayerDiscriminator, check_task_discriminator
from cat_tpu_torch.models.generator import DEFAULT_MAPPING_LAYERS, InceptionGenerator
from cat_tpu_torch.models.losses import gan_loss, gradient_penalty, recon_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.ops.quant import TEACHER_DTYPES, teacher_forward
from cat_tpu_torch.parallel import spatial
from cat_tpu_torch.train.common import (GANTrainState, NetState, average_grads, cast_floats,
                                        checkpointed, global_metrics)
from cat_tpu_torch.train.optim import Adam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DistillHParams:
    dataset_mode: str = "aligned"  # aligned | unaligned
    gan_mode: str = "hinge"
    recon_loss_type: str = "l1"
    distill_loss_type: str = "ka"  # ka | mse
    lambda_gan: float = 1.0
    lambda_recon: float = 100.0
    lambda_distill: float = 1.0
    beta1: float = 0.5
    init_type: str = "normal"
    init_gain: float = 0.02
    mapping_layers: Tuple[str, ...] = DEFAULT_MAPPING_LAYERS
    compute_dtype: str = "float32"  # float32 | bfloat16
    teacher_compute_dtype: str = ""  # '' follows compute_dtype; int8 | int8_static (ops/quant.py)
    fused_norms: bool = False  # affine instance norm + relu through the fused kernel
    packed_blocks: bool = True  # branch-packed inception blocks (same math)
    remat: bool = False  # recompute the student forward in the backward
    ema_decay: float = 0.0  # student-weight EMA (--moving_average_decay); 0 = off


def _check_ported(hp: DistillHParams) -> None:
    if hp.teacher_compute_dtype not in TEACHER_DTYPES:
        raise ValueError(f"teacher_compute_dtype must be one of {TEACHER_DTYPES}")
    if hp.distill_loss_type not in ("ka", "mse"):
        raise NotImplementedError(hp.distill_loss_type)
    if hp.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")


class Adaptor(nn.Conv2d):
    """1x1 conv with bias from the student's bottleneck width to the
    teacher's.  Initialised as flax's ``nn.Conv`` default: LeCun normal
    (truncated at two standard deviations) kernel, zero bias."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, 1)
        # a unit normal truncated to [-2, 2] has std 0.8796
        std = math.sqrt(1.0 / cin) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.bias.zero_()


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
        check_task_discriminator(disc_cfg)
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
        self.netA: Optional[nn.ModuleDict] = None  # adaptors, mse only
        self._act_scales: Optional[Tuple[float, ...]] = None  # int8_static: calibrated by the first step

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
        comes from ``teacher_state_dict``; the student, D and (mse) the
        adaptors are freshly initialised from ``seed`` unless their
        state_dicts are given.  Returns (state, teacher parameters)."""
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

        a_params: Dict[str, torch.Tensor] = {}
        if self.hp.distill_loss_type == "mse":
            sb, tb = self.student_cfg.bottleneck, self.teacher_cfg.bottleneck
            self.netA = nn.ModuleDict({
                f"A{i}": Adaptor(sb, tb, gen) for i in range(len(self.hp.mapping_layers))
            }).to(self.device)
            a_params = dict(self.netA.named_parameters())

        g_params = dict(self.netG_student.named_parameters())
        d_params = dict(self.netD.named_parameters())
        extra = {}
        if self.hp.ema_decay > 0:
            extra["ema_G"] = {k: v.detach().clone() for k, v in g_params.items()}
        state = GANTrainState(
            step=0,
            # one Adam over {G, A}, as the JAX package's G parameter group
            g=NetState(g_params, Adam([*g_params.values(), *a_params.values()], self.hp.beta1),
                       dict(self.netG_student.named_buffers())),
            d=NetState(d_params, Adam(d_params.values(), self.hp.beta1),
                       dict(self.netD.named_buffers())),
            rng=torch.Generator(device=self.device).manual_seed(seed),
            adaptors=a_params,
            extra=extra,
        )
        return state, dict(self.netG_teacher.named_parameters())

    # ------------------------------------------------------------------- step

    def _distill_loss(self, a_params, s_acts, t_acts):
        losses = {}
        total = torch.zeros((), device=self.device)
        for i, name in enumerate(self.hp.mapping_layers):
            s, t = s_acts[name], t_acts[name]
            if self.hp.distill_loss_type == "ka":
                li = -ka(s, t)
            else:
                mapped = F.conv2d(s, a_params[f"A{i}.weight"], a_params[f"A{i}.bias"])
                li = spatial.mean((mapped - t).square())
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

        # KA takes the taps in the compute dtype; the adaptors in float32
        up_acts = (lambda t: t) if hp.distill_loss_type == "ka" else up

        real_A = down(batch["A"])
        real_B = batch.get("B", batch["A"])
        taps = hp.mapping_layers
        aligned = hp.dataset_mode == "aligned"

        # --- teacher forward: frozen, eval mode ---
        (t_fake, t_acts), self._act_scales = teacher_forward(
            self._teacher_fn, down(teacher_params), real_A, hp.teacher_compute_dtype,
            self._act_scales)
        t_fake, t_acts = up(t_fake), up_acts(t_acts)

        # --- student forward once, graph kept; it alone moves the student's
        # running statistics ---
        s_params = state.g.params

        def s_forward():
            fake, acts = functional_call(
                self.netG_student, down(s_params), (real_A,),
                {"train": True, "taps": taps, "generator": state.rng},
            )
            return up(fake), up_acts(acts)

        if hp.remat:
            s_fake, s_acts = checkpointed(s_forward, self.netG_student, state.rng)
        else:
            s_fake, s_acts = s_forward()

        # --- discriminator update on the detached fake ---
        fake_d = down(s_fake.detach())
        if aligned:
            fake_in = torch.cat([real_A, fake_d], 1)
            real_in = torch.cat([real_A, down(real_B)], 1)
        else:
            fake_in, real_in = fake_d, down(real_B)
        d_params = state.d.params
        d_down = down(d_params)

        def d_apply(params, x):
            return up(functional_call(self.netD, params, (x,), {"train": True}))

        # the fake, then the real forward move D's running statistics
        l_d_fake = gan_loss(d_apply(d_down, fake_in), False, hp.gan_mode, True)
        l_d_real = gan_loss(d_apply(d_down, real_in), True, hp.gan_mode, True)
        d_loss = 0.5 * (l_d_fake + l_d_real)
        if hp.gan_mode == "wgangp":
            # the Lipschitz penalty, as the JAX package applies it (the
            # reference defines it and never calls it)
            with frozen_stats(self.netD):
                l_d_gp, _ = gradient_penalty(lambda x: d_apply(d_down, x), real_in, fake_in,
                                             generator=state.rng)
            d_loss = d_loss + l_d_gp
        d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
        state.d.opt.step(average_grads(d_grads), lr)

        # --- generator + adaptor update through the updated D (no gradient into D) ---
        recon_target = real_B if aligned else t_fake
        d_in = torch.cat([real_A, down(s_fake)], 1) if aligned else down(s_fake)
        d_frozen = down({k: v.detach() for k, v in d_params.items()})
        with frozen_stats(self.netD):
            pred = functional_call(self.netD, d_frozen, (d_in,), {"train": True})
        l_g_gan = gan_loss(up(pred), True, hp.gan_mode, False) * hp.lambda_gan
        l_g_rec = recon_loss(s_fake, recon_target, hp.recon_loss_type) * hp.lambda_recon
        if hp.lambda_distill > 0:
            l_g_dis, dis_parts = self._distill_loss(state.adaptors, s_acts, t_acts)
            l_g_dis = l_g_dis * hp.lambda_distill
        else:
            l_g_dis, dis_parts = torch.zeros((), device=self.device), {}
        g_group = [*s_params.values(), *state.adaptors.values()]
        # an adaptor is unused when lambda_distill is 0
        rng_now = state.rng.get_state()
        g_grads = torch.autograd.grad(l_g_gan + l_g_rec + l_g_dis, g_group,
                                      allow_unused=True, materialize_grads=True)
        state.rng.set_state(rng_now)  # a remat recompute rewound it
        state.g.opt.step(average_grads(g_grads), lr)

        if hp.ema_decay > 0:
            ema = list(state.extra["ema_G"].values())
            with torch.no_grad():
                torch._foreach_mul_(ema, hp.ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul(list(s_params.values()),
                                                            1.0 - hp.ema_decay))

        state.step += 1
        metrics = {
            "G_loss/gan": l_g_gan,
            "G_loss/recon": l_g_rec,
            "G_loss/distill": l_g_dis,
            "D_loss/fake": l_d_fake,
            "D_loss/real": l_d_real,
            **dis_parts,
        }
        return state, global_metrics(metrics)

    def _teacher_fn(self, params, x):
        return functional_call(self.netG_teacher, params, (x,),
                               {"train": False, "taps": self.hp.mapping_layers})

    # -------------------------------------------------------------- inference

    def student_eval_params(self, state: GANTrainState) -> Dict[str, torch.Tensor]:
        """The EMA weights when ``ema_decay`` > 0, else the trained weights:
        what evaluation and deployment use."""
        return state.extra.get("ema_G", state.g.params)

    @torch.no_grad()
    def generate_student(self, state: GANTrainState, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_student, self.student_eval_params(state), (x,))

    @torch.no_grad()
    def generate_teacher(self, teacher_params: Dict[str, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_teacher, teacher_params, (x,))
