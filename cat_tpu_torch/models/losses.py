"""GAN and reconstruction objectives and the WGAN-GP gradient penalty (port
of ``cat_tpu/models/losses.py``).

Over a split height (``parallel/spatial.py``) the means are over the global
tensor (``spatial.mean``: shards may be uneven), and the penalty's
per-sample norm sums its squares over the spatial axis before the square
root."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from cat_tpu_torch.parallel import collectives, spatial

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

    mean = spatial.mean
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return mean(torch.square(prediction - target))
    if mode == "vanilla":
        target = torch.full_like(prediction, 1.0 if target_is_real else 0.0)
        if not spatial.active():
            return F.binary_cross_entropy_with_logits(prediction, target)
        return mean(F.binary_cross_entropy_with_logits(prediction, target, reduction="none"))
    if mode == "wgangp":
        return -mean(prediction) if target_is_real else mean(prediction)
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -mean(torch.clamp_max(prediction - 1.0, 0.0))
            return -mean(torch.clamp_max(-prediction - 1.0, 0.0))
        if not target_is_real:
            raise ValueError("hinge generator loss is only defined for real targets")
        return -mean(prediction)
    raise NotImplementedError(f"gan mode {mode} not implemented")


def mixing_weights(n: int, generator: Optional[torch.Generator],
                   like: torch.Tensor) -> torch.Tensor:
    """Per-sample interpolation weights α ~ U[0, 1) of the mixed penalty,
    shaped (n, 1, 1, 1) to broadcast over an NCHW batch.  Over several ranks
    the global batch's weights are drawn on every rank and this rank's rows
    kept, so the ranks draw what one process would."""
    return collectives.local_rows(torch.rand(
        (collectives.global_rows(n),) + (1,) * (like.dim() - 1), generator=generator,
        device=like.device, dtype=like.dtype))


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def gradient_penalty(d_apply: Callable, real: torch.Tensor, fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None, gp_type: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0):
    """WGAN-GP gradient penalty (reference models/modules/loss.py:100-147):
    ``mean((||dD/dx||_2 - constant)²) · lambda_gp``, the per-sample norm over
    the flattened non-batch dims, with the reference's ``+ 1e-16`` shift.
    ``d_apply`` maps an image batch to logits (a tensor, or nested lists of
    them, all summed).  The gradient keeps its graph, so the penalty
    differentiates back into D's parameters.  ``real`` and ``fake`` are
    taken as constants.  Returns ``(penalty, gradients)``; ``(0, None)``
    when ``lambda_gp <= 0``."""
    if lambda_gp <= 0.0:
        return torch.zeros((), device=real.device), None
    real, fake = real.detach(), fake.detach()
    if gp_type == "real":
        x = real
    elif gp_type == "fake":
        x = fake
    elif gp_type == "mixed":
        alpha = mixing_weights(real.shape[0], generator, real)
        x = alpha * real + (1.0 - alpha) * fake
    else:
        raise NotImplementedError(f"gradient penalty type {gp_type!r}")
    x = x.requires_grad_(True)
    total = sum(leaf.sum() for leaf in _leaves(d_apply(x)))
    (grads,) = torch.autograd.grad(total, x, create_graph=True)
    # the norm in float32: under bf16 the 1e-16 shift would underflow to 0
    flat = (grads.float() + 1e-16).reshape(real.shape[0], -1)
    norm = collectives.all_reduce_sum(flat.square().sum(dim=1), "spatial").sqrt()
    return (norm - constant).square().mean() * lambda_gp, grads


def recon_loss(x: torch.Tensor, y: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    """Reconstruction objective (l1 | l2 | smooth_l1)."""
    if kind == "l1":
        return spatial.mean(torch.abs(x - y))
    if kind == "l2":
        return spatial.mean(torch.square(x - y))
    if kind == "smooth_l1":
        d = x - y
        ad = torch.abs(d)
        return spatial.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))
    raise NotImplementedError(f"recon loss {kind!r} not implemented")
