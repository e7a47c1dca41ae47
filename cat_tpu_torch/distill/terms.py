"""The distillation terms the distillers share: the hyperparameter check,
the mse adaptors and Σ_taps d(student tap, teacher tap).

d is -KA (``ka``, ``distill/ka.py``; the hand-written Gram kernel on the
card) or the mean squared error of a 1x1-conv adaptor of the student tap
against the teacher tap (``mse``; one adaptor a tap, trained with the
student by one Adam, as in the JAX package's {G, A} parameter group).
Over a split height (``parallel/spatial.py``) the adaptor's conv and the
mean are over the global tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from cat_tpu_torch.distill.ka import ka
from cat_tpu_torch.ops.quant import TEACHER_DTYPES
from cat_tpu_torch.parallel import spatial


def check_hparams(hp) -> None:
    """Refuse a teacher dtype or a distillation loss the distillers do not
    run (``hp.teacher_compute_dtype`` where the distiller has one)."""
    if getattr(hp, "teacher_compute_dtype", "") not in TEACHER_DTYPES:
        raise ValueError(f"teacher_compute_dtype must be one of {TEACHER_DTYPES}")
    if hp.distill_loss_type not in ("ka", "mse"):
        raise NotImplementedError(hp.distill_loss_type)


class Adaptor(nn.Conv2d):
    """1x1 conv with bias from the student's tap width to the teacher's.
    Initialised as flax's ``nn.Conv`` default: LeCun normal (truncated at
    two standard deviations) kernel, zero bias."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, 1)
        # a unit normal truncated to [-2, 2] has std 0.8796
        std = math.sqrt(1.0 / cin) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            self.bias.zero_()


def adaptors(widths: Sequence[Tuple[int, int]],
             generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """``A{i}``, tap i's adaptor from its (student, teacher) widths, drawn
    from ``generator`` in tap order."""
    return nn.ModuleDict({f"A{i}": Adaptor(s, t, generator) for i, (s, t) in enumerate(widths)})


def distill_terms(kind: str, taps: Sequence[str], a_params: Dict[str, torch.Tensor],
                  s_acts: Dict[str, torch.Tensor], t_acts: Dict[str, torch.Tensor],
                  device) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(Σ_taps d, {``Specific_loss/distill{i}``: tap i's d}) for ``kind``
    ka or mse; ``a_params`` holds the adaptors' parameters
    (``A{i}.weight``, ``A{i}.bias``) under mse."""
    total = torch.zeros((), device=device)
    parts = {}
    for i, name in enumerate(taps):
        s, t = s_acts[name], t_acts[name]
        if kind == "ka":
            li = -ka(s, t)
        else:
            mapped = spatial.conv2d_fn(s, a_params[f"A{i}.weight"], a_params[f"A{i}.bias"])
            li = spatial.mean((mapped - t).square())
        parts[f"Specific_loss/distill{i}"] = li
        total = total + li
    return total, parts
