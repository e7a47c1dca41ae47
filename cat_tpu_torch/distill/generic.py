"""Module-agnostic KA feature distiller (port of ``cat_tpu/distill/generic.py``).

Distills any teacher/student pair whose forward takes ``taps=`` and returns
``(output, {tap: activation})``, e.g. the diffusion UNet
(``models/unet.py``).  One ``train_step``:

  * the frozen teacher runs under no_grad and returns its output and taps;
  * the student runs forward once; its loss is λ_recon · recon(student out,
    teacher out) + λ_distill · Σ_taps d(student tap, teacher tap), with
    d = -KA (``ka``; the Gram kernel on the card) or the mean squared error
    of a 1x1-conv adaptor of the student tap against the teacher tap
    (``mse``), one adaptor a tap, trained with the student by one Adam at
    the hyperparameters' betas;
  * no discriminator.

Each phase of the step runs inside a ``utils/trace.py::span``:
``step.teacher_fwd`` (the input and teacher casts, the teacher),
``step.student_fwd``, ``step.g_loss_bwd`` (recon, the distill terms,
``autograd.grad``) and ``step.adam``.

Mixed precision is ``train/common.py::Precision``'s: the parameters cast
flat but for those a net names in its ``float32_params()``, which stay
float32 masters, as ADM's norms.  The device is explicit (CUDA unless
``device="cpu"``), and so is the adaptors' generator (``seed``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.distill.terms import adaptors, check_hparams, distill_terms
from cat_tpu_torch.models.losses import recon_loss
from cat_tpu_torch.train.common import Precision
from cat_tpu_torch.train.optim import Adam
from cat_tpu_torch.utils.trace import span


@dataclass(frozen=True)
class GenericDistillHParams:
    distill_loss_type: str = "ka"  # ka | mse
    recon_loss_type: str = "l2"
    lambda_recon: float = 1.0
    lambda_distill: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.999
    mapping_layers: Tuple[str, ...] = ()
    compute_dtype: str = "float32"  # float32 | bfloat16 (float32 masters)


@dataclass
class GenericState:
    """The student's parameters (its module's own tensors), the adaptors'
    (``A{i}.weight``/``A{i}.bias``, mse only), their one Adam, the step."""

    step: int
    params: Dict[str, torch.Tensor]
    adaptors: Dict[str, torch.Tensor]
    opt: Adam


class GenericDistiller:
    """Distill ``teacher`` -> ``student`` on a tuple of inputs."""

    def __init__(self, teacher: nn.Module, student: nn.Module,
                 teacher_tap_widths: Dict[str, int], student_tap_widths: Dict[str, int],
                 hp: GenericDistillHParams, device=None):
        check_hparams(hp)
        self.prec = Precision(hp.compute_dtype, hp.distill_loss_type)
        self.device = resolve_device(device)
        self.teacher = teacher.requires_grad_(False).to(self.device).eval()
        self.student = student.to(self.device)
        self.t_widths, self.s_widths = teacher_tap_widths, student_tap_widths
        self.hp = hp
        self.netA: Optional[nn.ModuleDict] = None

    def init_state(self, seed: int = 0) -> Tuple[GenericState, Dict[str, torch.Tensor]]:
        """The train state over the student's current weights, with fresh
        adaptors (mse) drawn from ``seed``; returns (state, teacher
        parameters)."""
        a_params: Dict[str, torch.Tensor] = {}
        if self.hp.distill_loss_type == "mse":
            gen = torch.Generator().manual_seed(seed)
            self.netA = adaptors([(self.s_widths[name], self.t_widths[name])
                                  for name in self.hp.mapping_layers], gen).to(self.device)
            a_params = dict(self.netA.named_parameters())
        params = dict(self.student.named_parameters())
        opt = Adam([*params.values(), *a_params.values()], self.hp.beta1, self.hp.beta2)
        return GenericState(0, params, a_params, opt), dict(self.teacher.named_parameters())

    def train_step(self, state: GenericState, teacher_params: Dict[str, torch.Tensor],
                   inputs: Tuple[torch.Tensor, ...],
                   lr: float) -> Tuple[GenericState, Dict[str, torch.Tensor]]:
        """One step; updates the student and adaptors in place and returns
        the state with the step's losses (0-d tensors)."""
        hp, prec = self.hp, self.prec
        taps = hp.mapping_layers
        dev = self.device
        with span("step.teacher_fwd", dev):
            inputs = tuple(prec.inputs(x) for x in inputs)
            with torch.no_grad():
                t_out, t_acts = functional_call(self.teacher,
                                                prec.params(teacher_params, self.teacher),
                                                inputs, {"taps": taps})
            t_out, t_acts = prec.outputs(t_out), prec.taps(t_acts)

        with span("step.student_fwd", dev):
            s_out, s_acts = functional_call(self.student, prec.params(state.params, self.student),
                                            inputs, {"taps": taps})
            s_out, s_acts = prec.outputs(s_out), prec.taps(s_acts)
        with span("step.g_loss_bwd", dev):
            l_rec = recon_loss(s_out, t_out, hp.recon_loss_type) * hp.lambda_recon
            l_dis, parts = distill_terms(hp.distill_loss_type, taps, state.adaptors, s_acts,
                                         t_acts, dev)
            l_dis = l_dis * hp.lambda_distill
            grads = torch.autograd.grad(l_rec + l_dis,
                                        [*state.params.values(), *state.adaptors.values()],
                                        allow_unused=True, materialize_grads=True)
        with span("step.adam", dev):
            state.opt.step(grads, lr)
        state.step += 1
        return state, {"G_loss/recon": l_rec.detach(), "G_loss/distill": l_dis.detach(),
                       **{k: v.detach() for k, v in parts.items()}}

    @torch.no_grad()
    def generate(self, state: GenericState, *inputs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.student, state.params, inputs)
