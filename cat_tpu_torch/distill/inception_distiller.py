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

Mixed precision is ``train/common.py::Precision``'s (float32 masters, the
parameters cast flat inside the forward); norm statistics are float32.

The step's phases run inside ``utils/trace.py::span``s (``step.teacher_fwd``,
``step.student_fwd``, ``step.d_loss_bwd``, ``step.adam``, ``step.g_loss_bwd``,
``step.adam``), which do nothing unless a profiler is recording.

Over several ranks (``parallel/``) the step is the single-device step of
the global batch: each rank holds its data index's rows and, with
``--n_spatial``, its spatial index's height rows of every image; the
networks, losses and KA take the other ranks' rows and sums through their
collectives, and the parameter gradients are averaged over the world.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
from cat_tpu_torch.distill.terms import adaptors, check_hparams, distill_terms
from cat_tpu_torch.models.discriminators import NLayerDiscriminator, check_task_discriminator
from cat_tpu_torch.models.generator import DEFAULT_MAPPING_LAYERS, InceptionGenerator
from cat_tpu_torch.models.losses import gan_loss, gradient_penalty, recon_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.ops.quant import teacher_forward
from cat_tpu_torch.train import common
from cat_tpu_torch.train.common import (GANTrainState, Precision, average_grads, checkpointed,
                                        ema_extra, global_metrics, net_state, update_ema)
from cat_tpu_torch.utils.trace import span


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
    fused_norms: bool = False  # the generators' affine instance norms through the fused kernel
    packed_blocks: bool = True  # branch-packed inception blocks (same math)
    remat: bool = False  # recompute the student forward in the backward
    ema_decay: float = 0.0  # student-weight EMA (--moving_average_decay); 0 = off


class InceptionDistiller:
    def __init__(
        self,
        teacher_cfg: InceptionGeneratorConfig,
        student_cfg: InceptionGeneratorConfig,
        disc_cfg: Optional[NLayerDiscriminatorConfig] = None,
        hp: DistillHParams = DistillHParams(),
        device=None,
    ):
        check_hparams(hp)
        self.prec = Precision(hp.compute_dtype, hp.distill_loss_type)
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
            widths = [(self.student_cfg.bottleneck, self.teacher_cfg.bottleneck)] * len(
                self.hp.mapping_layers)
            self.netA = adaptors(widths, gen).to(self.device)
            a_params = dict(self.netA.named_parameters())
        g = net_state(self.netG_student, self.hp.beta1, extra=a_params.values())
        state = GANTrainState(
            step=0, g=g, d=net_state(self.netD, self.hp.beta1),
            rng=torch.Generator(device=self.device).manual_seed(seed),
            adaptors=a_params, extra=ema_extra(g.params, self.hp.ema_decay))
        return state, dict(self.netG_teacher.named_parameters())

    # ------------------------------------------------------------------- step

    def train_step(
        self,
        state: GANTrainState,
        teacher_params: Dict[str, torch.Tensor],
        batch: Dict[str, torch.Tensor],
        lr: float,
    ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One D-then-G step; updates ``state``'s parameters and optimisers in
        place and returns it with the step's losses (0-d tensors)."""
        hp, prec = self.hp, self.prec
        real_B = batch.get("B", batch["A"])
        taps = hp.mapping_layers
        aligned = hp.dataset_mode == "aligned"
        dev = self.device

        # --- teacher forward: frozen, eval mode ---
        with span("step.teacher_fwd", dev):
            real_A = prec.inputs(batch["A"])
            (t_fake, t_acts), self._act_scales = teacher_forward(
                self._teacher_fn, prec.params(teacher_params, self.netG_teacher), real_A,
                hp.teacher_compute_dtype, self._act_scales)
            t_fake, t_acts = prec.outputs(t_fake), prec.taps(t_acts)

        # --- student forward once, graph kept; it alone moves the student's
        # running statistics ---
        s_params = state.g.params

        def s_forward():
            fake, acts = functional_call(
                self.netG_student, prec.params(s_params, self.netG_student), (real_A,),
                {"train": True, "taps": taps, "generator": state.rng},
            )
            return prec.outputs(fake), prec.taps(acts)

        with span("step.student_fwd", dev):
            if hp.remat:
                s_fake, s_acts = checkpointed(s_forward, self.netG_student, state.rng)
            else:
                s_fake, s_acts = s_forward()

        # --- discriminator update on the detached fake ---
        d_params = state.d.params

        def d_apply(params, x):
            return prec.outputs(functional_call(self.netD, params, (x,), {"train": True}))

        with span("step.d_loss_bwd", dev):
            fake_d = prec.inputs(s_fake.detach())
            if aligned:
                fake_in = torch.cat([real_A, fake_d], 1)
                real_in = torch.cat([real_A, prec.inputs(real_B)], 1)
            else:
                fake_in, real_in = fake_d, prec.inputs(real_B)
            d_down = prec.params(d_params, self.netD)
            # the fake, then the real forward move D's running statistics
            l_d_fake = gan_loss(d_apply(d_down, fake_in), False, hp.gan_mode, True)
            l_d_real = gan_loss(d_apply(d_down, real_in), True, hp.gan_mode, True)
            d_loss = 0.5 * (l_d_fake + l_d_real)
            if hp.gan_mode == "wgangp":
                # the Lipschitz penalty, as the JAX package applies it (the
                # reference defines it and never calls it)
                with frozen_stats(self.netD):
                    l_d_gp, _ = gradient_penalty(lambda x: d_apply(d_down, x), real_in,
                                                 fake_in, generator=state.rng)
                d_loss = d_loss + l_d_gp
            d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
        with span("step.adam", dev):
            state.d.opt.step(average_grads(d_grads), lr)

        # --- generator + adaptor update through the updated D (no gradient into D) ---
        with span("step.g_loss_bwd", dev):
            recon_target = real_B if aligned else t_fake
            d_in = torch.cat([real_A, prec.inputs(s_fake)], 1) if aligned else prec.inputs(s_fake)
            d_frozen = prec.params({k: v.detach() for k, v in d_params.items()}, self.netD)
            with frozen_stats(self.netD):
                pred = functional_call(self.netD, d_frozen, (d_in,), {"train": True})
            l_g_gan = gan_loss(prec.outputs(pred), True, hp.gan_mode, False) * hp.lambda_gan
            l_g_rec = recon_loss(s_fake, recon_target, hp.recon_loss_type) * hp.lambda_recon
            if hp.lambda_distill > 0:
                l_g_dis, dis_parts = distill_terms(hp.distill_loss_type, taps, state.adaptors,
                                                   s_acts, t_acts, dev)
                l_g_dis = l_g_dis * hp.lambda_distill
            else:
                l_g_dis, dis_parts = torch.zeros((), device=self.device), {}
            g_group = [*s_params.values(), *state.adaptors.values()]
            # an adaptor is unused when lambda_distill is 0
            rng_now = state.rng.get_state()
            g_grads = torch.autograd.grad(l_g_gan + l_g_rec + l_g_dis, g_group,
                                          allow_unused=True, materialize_grads=True)
            state.rng.set_state(rng_now)  # a remat recompute rewound it
        with span("step.adam", dev):
            state.g.opt.step(average_grads(g_grads), lr)
            update_ema(state, hp.ema_decay)

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
        """``train/common.py::student_eval_params``."""
        return common.student_eval_params(state)

    @torch.no_grad()
    def generate_student(self, state: GANTrainState, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_student, self.student_eval_params(state), (x,))

    @torch.no_grad()
    def generate_teacher(self, teacher_params: Dict[str, torch.Tensor],
                         x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_teacher, teacher_params, (x,))
