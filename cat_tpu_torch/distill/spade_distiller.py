"""The SPADE (GauGAN) distiller (port of ``cat_tpu/distill/spade_distiller.py``).

Reference: distillers/base_spade_distiller.py + spade_distiller.py and
models/modules/spade_modules/{base_spade_distiller_modules,
spade_distiller_modules}.py.  One ``train_step`` does what the JAX
package's ``_step`` does:

  * the frozen teacher runs in eval mode and returns its taps (by default
    ``head_0``, ``G_middle_1``, ``up_1``);
  * the G update runs first, against the old D: G loss = hinge GAN +
    feature matching · λ_feat + VGG · λ_vgg + λ_distill · Σ_taps d(student
    tap, teacher tap), with d = -KA (``ka``, the hand-written Gram kernel on
    the card) or the mean squared error of a 1x1-conv adaptor of the
    student tap against the teacher tap (``mse``).  The adaptors, one per
    tap, sit in the G group under TTUR (G at lr/2, D at 2·lr, Adam betas
    (0, 0.9), unless ``no_TTUR``) and are there under KA too, where their
    gradient is zero;
  * the student's forward in the G step alone moves its running statistics;
    the G loss's D forward leaves D's spectral ``u`` alone;
  * the D update runs on a fake regenerated by the *updated* student in
    train mode (batch statistics) whose statistics writes are discarded;
    its fake-and-real forward writes D's ``u``; under wgangp the penalty's
    forwards start from the ``u`` of before the step;
  * with ``ema_decay`` > 0 an exponential moving average of the student's
    weights follows every G step and is what evaluation and deployment use;
  * with ``remat`` the student's forward is recomputed in the backward
    (``torch.utils.checkpoint``), selectively under ``remat_policy`` (a
    ``jax.checkpoint_policies`` name); without ``remat`` the policy is
    ignored, as in the JAX package;
  * with ``teacher_compute_dtype`` 'int8' or 'int8_static' the teacher's
    convolutions run in int8, as in the inception distiller
    (``ops/quant.py``; static scales calibrated on the first batch).

Over a split height (``--n_spatial``) the step is the single-device step
of the global batch: the semantics whole on every rank, the taps, fakes
and photos the rank's rows (``train/spade_model.py``); KA sums its partial
Grams over the spatial axis (``distill/ka.py``), the ``mse`` adaptors'
means and the GAN, feature and VGG terms are over the global tensors,
and remat's recompute replays the halo exchanges, which every rank runs
in the same order.

The step's phases run inside ``utils/trace.py::span``s (``step.teacher_fwd``,
``step.student_fwd``, ``step.g_loss_bwd``, ``step.adam``, ``step.d_loss_bwd``,
``step.adam``), which do nothing unless a profiler is recording.

Mixed precision is ``train/common.py::Precision``'s, as in
``train/spade_model.py``; norm statistics, losses and both taps (under KA
too) are float32.
Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig, SPADEGeneratorConfig
from cat_tpu_torch.distill.terms import adaptors, check_hparams, distill_terms
from cat_tpu_torch.models.losses import gan_loss, gradient_penalty
from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator
from cat_tpu_torch.models.vgg import VGG19Features, vgg_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.ops.quant import teacher_forward
from cat_tpu_torch.train import common
from cat_tpu_torch.train.common import (GANTrainState, Precision, average_grads, checkpointed,
                                        ema_extra, global_metrics, net_state, update_ema)
from cat_tpu_torch.train.spade_model import (d_input, discriminate, feature_matching_loss,
                                              preprocess_input)
from cat_tpu_torch.utils.trace import span

DEFAULT_SPADE_MAPPING_LAYERS = ("head_0", "G_middle_1", "up_1")

# the jax.checkpoint_policies names a bare name can select -> the aten ops
# whose outputs the recompute reads instead of recomputing (None: save
# nothing; "all": no recompute at all)
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
REMAT_POLICIES = {
    "everything_saveable": "all",
    "nothing_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "checkpoint_dots_with_no_batch_dims": ("mm", "addmm"),
}


def remat_policy(name: str):
    """The selective-checkpoint policy of a ``jax.checkpoint_policies``
    name: "all" (everything saved: the forward runs as without remat), None
    (nothing saved: plain ``torch.utils.checkpoint``, as ``--remat 1``
    without a policy) or a policy function saving the outputs of the dots.
    JAX's dots are ``dot_general``, not ``conv_general_dilated``, so the
    dots policies save no convolution: for a generator of convolutions they
    are nearly ``nothing_saveable``.  The policies that take arguments
    (``save_only_these_names``, ``offload_dot_with_no_batch_dims``, ...)
    cannot be named alone; they and unknown names raise ``ValueError``."""
    if name == "":
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"--remat_policy {name!r}: the supported names are "
                         f"{', '.join(sorted(REMAT_POLICIES))}")
    ops = REMAT_POLICIES[name]
    if ops is None or ops == "all":
        return ops
    from torch.utils.checkpoint import CheckpointPolicy

    saved = {getattr(torch.ops.aten, op) for op in ops}

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


@dataclass(frozen=True)
class SPADEDistillHParams:
    gan_mode: str = "hinge"
    distill_loss_type: str = "ka"  # ka | mse
    lambda_gan: float = 1.0
    lambda_distill: float = 1.0
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_TTUR: bool = False
    beta1: float = 0.0
    beta2: float = 0.9
    init_type: str = "xavier"
    init_gain: float = 0.02
    mapping_layers: Tuple[str, ...] = DEFAULT_SPADE_MAPPING_LAYERS
    compute_dtype: str = "float32"  # float32 | bfloat16 (float32 masters)
    vgg_compute_dtype: str = "float32"  # dtype of the VGG19 sweep
    remat: bool = False  # recompute the student forward in the backward
    remat_policy: str = ""  # a jax.checkpoint_policies name (REMAT_POLICIES), read under remat
    packed_blocks: bool = True  # both generators' branches packed (models/spade.py)
    ema_decay: float = 0.0  # student-weight EMA (--moving_average_decay); 0 = off
    teacher_compute_dtype: str = ""  # '' follows compute_dtype; int8 | int8_static (ops/quant.py)


def _tap_width(cfg: SPADEGeneratorConfig, name: str) -> int:
    for bname, bcfg in zip(cfg.block_names, cfg.blocks):
        if bname == name:
            return bcfg.fout
    raise KeyError(name)


class SPADEDistiller:
    def __init__(self, teacher_cfg: SPADEGeneratorConfig, student_cfg: SPADEGeneratorConfig,
                 disc_cfg: Optional[MultiscaleDiscriminatorConfig] = None,
                 hp: SPADEDistillHParams = SPADEDistillHParams(),
                 vgg: Optional[VGG19Features] = None, input_nc: Optional[int] = None,
                 contain_dontcare: bool = False, device=None):
        """``vgg``: the perceptual loss's network (None: no VGG loss);
        ``input_nc``/``contain_dontcare``: how raw label batches become
        semantics (by default the label ids fill all but the edge channel)."""
        check_hparams(hp)
        self.prec = Precision(hp.compute_dtype)  # both taps float32, under KA too
        self.policy = remat_policy(hp.remat_policy) if hp.remat else None
        self.device = resolve_device(device)
        self.teacher_cfg, self.student_cfg = teacher_cfg, student_cfg
        self.disc_cfg = disc_cfg or MultiscaleDiscriminatorConfig(
            input_nc=teacher_cfg.semantic_nc + teacher_cfg.output_nc)
        self.hp = hp
        self.vgg = None if vgg is None else vgg.to(self.device)
        self.label_nc = input_nc or teacher_cfg.semantic_nc - 1
        self.contain_dontcare = contain_dontcare
        self.netG_teacher: Optional[SPADEGenerator] = None
        self.netG_student: Optional[SPADEGenerator] = None
        self.netD: Optional[MultiscaleDiscriminator] = None
        self.netA: Optional[nn.ModuleDict] = None
        self._act_scales: Optional[Tuple[float, ...]] = None  # int8_static: calibrated by the first step

    @property
    def lr_mults(self) -> Tuple[float, float]:
        """(G, D) learning-rate multipliers (TTUR)."""
        return (1.0, 1.0) if self.hp.no_TTUR else (0.5, 2.0)

    # ------------------------------------------------------------------ state

    def init_state(self, teacher_state_dict: Dict[str, torch.Tensor],
                   student_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   disc_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   seed: int = 0) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """Build the networks on the device and the train state.  The teacher
        comes from ``teacher_state_dict``; the student, D and the adaptors are
        freshly initialised from ``seed``.  ``student_state_dict`` warm-starts
        the student: its entries (typically the parameters alone, from
        ``compress/transfer.py``) override the fresh ones, and what it lacks
        (running statistics, spectral vectors) keeps its fresh value.
        Returns (state, teacher parameters)."""
        hp = self.hp
        gen = torch.Generator().manual_seed(seed)
        teacher = SPADEGenerator(self.teacher_cfg, hp.init_type, hp.init_gain, generator=gen,
                                 packed_blocks=hp.packed_blocks)
        teacher.load_state_dict(teacher_state_dict)
        self.netG_teacher = teacher.requires_grad_(False).to(self.device).eval()

        student = SPADEGenerator(self.student_cfg, hp.init_type, hp.init_gain, generator=gen,
                                 packed_blocks=hp.packed_blocks)
        if student_state_dict is not None:
            sd = student.state_dict()
            params = {k for k, _ in student.named_parameters()}
            unknown = student_state_dict.keys() - sd.keys()
            if unknown or not params <= student_state_dict.keys():
                raise ValueError(f"student warm start: {sorted(unknown)[:3]} are not the "
                                 f"student's, {sorted(params - student_state_dict.keys())[:3]} "
                                 "missing")
            student.load_state_dict({**sd, **student_state_dict})
        self.netG_student = student.to(self.device)

        netD = MultiscaleDiscriminator(self.disc_cfg, hp.init_type, hp.init_gain, generator=gen)
        if disc_state_dict is not None:
            netD.load_state_dict(disc_state_dict)
        self.netD = netD.to(self.device)

        widths = [(_tap_width(self.student_cfg, name), _tap_width(self.teacher_cfg, name))
                  for name in hp.mapping_layers]
        self.netA = adaptors(widths, gen).to(self.device)
        a_params = dict(self.netA.named_parameters())
        g = net_state(self.netG_student, hp.beta1, hp.beta2, a_params.values())
        state = GANTrainState(
            step=0, g=g, d=net_state(self.netD, hp.beta1, hp.beta2),
            rng=torch.Generator(device=self.device).manual_seed(seed),
            adaptors=a_params, extra=ema_extra(g.params, hp.ema_decay))
        return state, dict(self.netG_teacher.named_parameters())

    # ------------------------------------------------------------------- step

    def semantics(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The generators' input: ``batch["semantics"]`` where given, else
        made from a raw label (and instance) batch."""
        if "semantics" in batch:
            return batch["semantics"]
        return preprocess_input(batch["label"], batch.get("instance"), self.label_nc,
                                self.contain_dontcare)

    def train_step(self, state: GANTrainState, teacher_params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One G-then-D step; updates ``state`` in place and returns it with
        the step's losses (0-d tensors)."""
        hp, prec = self.hp, self.prec
        real_B = batch["image"]
        lr_g, lr_d = lr * self.lr_mults[0], lr * self.lr_mults[1]
        taps = hp.mapping_layers
        dev = self.device

        # --- the teacher: frozen, eval mode ---
        with span("step.teacher_fwd", dev):
            sem = prec.inputs(self.semantics(batch))
            (_, t_acts), self._act_scales = teacher_forward(
                self._teacher_fn, prec.params(teacher_params, self.netG_teacher), sem,
                hp.teacher_compute_dtype, self._act_scales)
            t_acts = prec.outputs(t_acts)

        # --- G update against the old D ---
        g_params = state.g.params

        def s_forward():
            fake, acts = functional_call(self.netG_student,
                                         prec.params(g_params, self.netG_student), (sem,),
                                         {"train": True, "taps": taps})
            return prec.outputs(fake), prec.outputs(acts)

        with span("step.student_fwd", dev):
            if hp.remat and self.policy != "all":
                fake, s_acts = checkpointed(s_forward, self.netG_student, state.rng,
                                            self.policy)
            else:
                fake, s_acts = s_forward()
        with span("step.g_loss_bwd", dev):
            d_frozen = {k: v.detach() for k, v in state.d.params.items()}
            with frozen_stats(self.netD):
                pred_fake, pred_real = discriminate(
                    self.netD, d_frozen, prec.outputs(sem), prec.outputs(prec.inputs(fake)),
                    prec.outputs(prec.inputs(real_B)))
            l_gan = gan_loss(pred_fake, True, hp.gan_mode, False) * hp.lambda_gan
            l_feat = feature_matching_loss(pred_fake, pred_real) * hp.lambda_feat
            if self.vgg is not None and hp.lambda_vgg > 0:
                l_vgg = vgg_loss(self.vgg, fake, real_B, hp.vgg_compute_dtype) * hp.lambda_vgg
            else:
                l_vgg = torch.zeros((), device=self.device)
            if hp.lambda_distill > 0:
                l_dis, parts = distill_terms(hp.distill_loss_type, taps, state.adaptors, s_acts,
                                             t_acts, dev)
                l_dis = l_dis * hp.lambda_distill
            else:
                l_dis, parts = torch.zeros((), device=self.device), {}
            rng_now = state.rng.get_state()
            # the adaptors take no gradient under KA: zeros, as in the JAX package
            g_grads = torch.autograd.grad(l_gan + l_feat + l_vgg + l_dis,
                                          [*g_params.values(), *state.adaptors.values()],
                                          allow_unused=True, materialize_grads=True)
            state.rng.set_state(rng_now)  # a remat recompute rewound it
        with span("step.adam", dev):
            state.g.opt.step(average_grads(g_grads), lr_g)

        # --- D update: the fake regenerated by the updated student in train
        # mode, its statistics writes discarded ---
        with span("step.d_loss_bwd", dev):
            with torch.no_grad(), frozen_stats(self.netG_student):
                fake = functional_call(self.netG_student,
                                       prec.params(g_params, self.netG_student), (sem,),
                                       {"train": True})
            d_down = prec.params(state.d.params, self.netD)
            d_loss = torch.zeros((), device=self.device)
            if hp.gan_mode == "wgangp":
                # the penalty's forwards read D's u of before the step: taken
                # before the one forward that writes it
                def d_apply(x):
                    return prec.outputs(functional_call(self.netD, d_down, (x,),
                                                        {"train": True}))

                with frozen_stats(self.netD):
                    d_loss, _ = gradient_penalty(d_apply, d_input(sem, prec.inputs(real_B)),
                                                 d_input(sem, fake), generator=state.rng)
            pred_fake, pred_real = discriminate(self.netD, d_down, sem, fake,
                                                prec.inputs(real_B))
            l_d_fake = gan_loss(prec.outputs(pred_fake), False, hp.gan_mode, True)
            l_d_real = gan_loss(prec.outputs(pred_real), True, hp.gan_mode, True)
            d_grads = torch.autograd.grad(l_d_fake + l_d_real + d_loss,
                                          list(state.d.params.values()))
        with span("step.adam", dev):
            state.d.opt.step(average_grads(d_grads), lr_d)
            update_ema(state, hp.ema_decay)

        state.step += 1
        metrics = {"G_loss/gan": l_gan, "G_loss/feat": l_feat, "G_loss/vgg": l_vgg,
                   "G_loss/distill": l_dis, "D_loss/fake": l_d_fake, "D_loss/real": l_d_real,
                   **parts}
        return state, global_metrics(metrics)

    def _teacher_fn(self, params, sem):
        return functional_call(self.netG_teacher, params, (sem,),
                               {"train": False, "taps": self.hp.mapping_layers})

    # -------------------------------------------------------------- inference

    def student_eval_params(self, state: GANTrainState) -> Dict[str, torch.Tensor]:
        """``train/common.py::student_eval_params``."""
        return common.student_eval_params(state)

    @torch.no_grad()
    def generate_student(self, state: GANTrainState, sem: torch.Tensor) -> torch.Tensor:
        """The student in eval mode (running statistics) on semantics."""
        return functional_call(self.netG_student, self.student_eval_params(state), (sem,))

    def generate_student_raw(self, state: GANTrainState, batch: Dict) -> torch.Tensor:
        """The student on a raw label (and instance) batch on the device: what
        the FID and mIoU evaluators call."""
        return self.generate_student(state, self.semantics(batch))

    @torch.no_grad()
    def generate_teacher(self, teacher_params: Dict[str, torch.Tensor],
                         sem: torch.Tensor) -> torch.Tensor:
        return functional_call(self.netG_teacher, teacher_params, (sem,))

    def generate_teacher_raw(self, teacher_params: Dict[str, torch.Tensor],
                             batch: Dict) -> torch.Tensor:
        return self.generate_teacher(teacher_params, self.semantics(batch))
