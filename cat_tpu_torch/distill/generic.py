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

Mixed precision follows the JAX package: float32 masters; parameters and
inputs cast to the compute dtype for the forwards (``down``); outputs cast
to float32 for the losses (``up``); KA takes the taps in the compute dtype,
the mse path in float32.  The device is explicit (CUDA unless
``device="cpu"``), and so is the adaptors' generator (``seed``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.distill.inception_distiller import Adaptor
from cat_tpu_torch.distill.ka import ka
from cat_tpu_torch.models.losses import recon_loss
from cat_tpu_torch.train.common import cast_floats
from cat_tpu_torch.train.optim import Adam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if hp.distill_loss_type not in ("ka", "mse"):
            raise NotImplementedError(hp.distill_loss_type)
        if hp.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.device = resolve_device(device)
        self.teacher = teacher.requires_grad_(False).to(self.device).eval()
        self.student = student.to(self.device)
        self.t_widths, self.s_widths = teacher_tap_widths, student_tap_widths
        self.hp = hp
        self.cdt = _DTYPES[hp.compute_dtype]
        self.netA: Optional[nn.ModuleDict] = None

    def init_state(self, seed: int = 0) -> Tuple[GenericState, Dict[str, torch.Tensor]]:
        """The train state over the student's current weights, with fresh
        adaptors (mse) drawn from ``seed``; returns (state, teacher
        parameters)."""
        a_params: Dict[str, torch.Tensor] = {}
        if self.hp.distill_loss_type == "mse":
            gen = torch.Generator().manual_seed(seed)
            self.netA = nn.ModuleDict({
                f"A{i}": Adaptor(self.s_widths[name], self.t_widths[name], gen)
                for i, name in enumerate(self.hp.mapping_layers)}).to(self.device)
            a_params = dict(self.netA.named_parameters())
        params = dict(self.student.named_parameters())
        opt = Adam([*params.values(), *a_params.values()], self.hp.beta1, self.hp.beta2)
        return GenericState(0, params, a_params, opt), dict(self.teacher.named_parameters())

    def _distill_loss(self, a_params, s_acts, t_acts):
        total = torch.zeros((), device=self.device)
        parts = {}
        for i, name in enumerate(self.hp.mapping_layers):
            s, t = s_acts[name], t_acts[name]
            if self.hp.distill_loss_type == "ka":
                li = -ka(s, t)
            else:
                mapped = F.conv2d(s, a_params[f"A{i}.weight"], a_params[f"A{i}.bias"])
                li = (mapped - t).square().mean()
            parts[f"Specific_loss/distill{i}"] = li
            total = total + li
        return total, parts

    def train_step(self, state: GenericState, teacher_params: Dict[str, torch.Tensor],
                   inputs: Tuple[torch.Tensor, ...],
                   lr: float) -> Tuple[GenericState, Dict[str, torch.Tensor]]:
        """One step; updates the student and adaptors in place and returns
        the state with the step's losses (0-d tensors)."""
        hp = self.hp
        taps = hp.mapping_layers
        mixed = self.cdt != torch.float32

        def down(t):
            return cast_floats(t, self.cdt) if mixed else t

        def up(t):
            return cast_floats(t, torch.float32) if mixed else t

        up_acts = (lambda t: t) if hp.distill_loss_type == "ka" else up
        inputs = tuple(down(x) for x in inputs)
        with torch.no_grad():
            t_out, t_acts = functional_call(self.teacher, down(teacher_params), inputs,
                                            {"taps": taps})
        t_out, t_acts = up(t_out), up_acts(t_acts)

        s_out, s_acts = functional_call(self.student, down(state.params), inputs,
                                        {"taps": taps})
        s_out, s_acts = up(s_out), up_acts(s_acts)
        l_rec = recon_loss(s_out, t_out, hp.recon_loss_type) * hp.lambda_recon
        l_dis, parts = self._distill_loss(state.adaptors, s_acts, t_acts)
        l_dis = l_dis * hp.lambda_distill
        grads = torch.autograd.grad(l_rec + l_dis,
                                    [*state.params.values(), *state.adaptors.values()],
                                    allow_unused=True, materialize_grads=True)
        state.opt.step(grads, lr)
        state.step += 1
        return state, {"G_loss/recon": l_rec.detach(), "G_loss/distill": l_dis.detach(),
                       **{k: v.detach() for k, v in parts.items()}}

    @torch.no_grad()
    def generate(self, state: GenericState, *inputs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.student, state.params, inputs)
