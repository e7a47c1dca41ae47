"""GAN and reconstruction objectives (port of ``cat_tpu/models/losses.py``;
``gradient_penalty`` is not ported yet)."""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

Pred = Union[torch.Tensor, Sequence]


def gan_loss(prediction: Pred, target_is_real: bool, mode: str = "lsgan",
             for_discriminator: bool = True) -> torch.Tensor:
    """GAN objective on discriminator logits.

    For multiscale discriminators ``prediction`` may be a list (of lists,
    whose last entry is the logit map); the per-scale losses are averaged.
    """
    if isinstance(prediction, (list, tuple)):
        losses = []
        for pred_i in prediction:
            if isinstance(pred_i, (list, tuple)):
                pred_i = pred_i[-1]
            losses.append(gan_loss(pred_i, target_is_real, mode, for_discriminator))
        return sum(losses) / len(losses)

    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean(torch.square(prediction - target))
    if mode == "vanilla":
        target = torch.full_like(prediction, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(prediction, target)
    if mode == "wgangp":
        return -torch.mean(prediction) if target_is_real else torch.mean(prediction)
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -torch.mean(torch.clamp_max(prediction - 1.0, 0.0))
            return -torch.mean(torch.clamp_max(-prediction - 1.0, 0.0))
        if not target_is_real:
            raise ValueError("hinge generator loss is only defined for real targets")
        return -torch.mean(prediction)
    raise NotImplementedError(f"gan mode {mode} not implemented")


def recon_loss(x: torch.Tensor, y: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    """Reconstruction objective (l1 | l2 | smooth_l1)."""
    if kind == "l1":
        return torch.mean(torch.abs(x - y))
    if kind == "l2":
        return torch.mean(torch.square(x - y))
    if kind == "smooth_l1":
        d = x - y
        ad = torch.abs(d)
        return torch.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))
    raise NotImplementedError(f"recon loss {kind!r} not implemented")
