"""Adam with the JAX package's semantics, and the epoch-level LR schedules
(port of ``cat_tpu/train/optim.py``).

The JAX package's ``adam_tx`` is a direction-only Adam (``scale_by_adam``:
b1, b2 = 0.999, eps = 1e-8, bias-corrected, eps outside the square root)
and applies the learning rate afterwards, so the LR is a runtime scalar of
every step:

    mu = b1·mu + (1-b1)·g,   nu = b2·nu + (1-b2)·g²,   t += 1
    p -= lr · (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)

Written out with multi-tensor (``_foreach``) ops rather than
``torch.optim.Adam``, whose first use imports TorchDynamo.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import torch


class Adam:
    """Direction-only Adam state over a fixed list of parameters."""

    def __init__(self, params: Iterable[torch.Tensor], beta1: float = 0.5,
                 beta2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        """Update the parameters in place along ``grads`` at ``lr``."""
        b1, b2 = self.beta1, self.beta2
        grads = list(grads)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(self.params, torch._foreach_div(mu_hat, denom), alpha=-lr)

    def state_dict(self, names: Sequence[str]) -> Dict:
        """The moments keyed by the parameters' ``names`` (in the order the
        optimiser was given them), and the step count."""
        names = list(names)
        return {"count": self.count, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict, names: Sequence[str]) -> None:
        self.count = int(sd["count"])
        for t, n in zip(self.mu, names):
            t.copy_(sd["mu"][n])
        for t, n in zip(self.nu, names):
            t.copy_(sd["nu"][n])


# ---------------------------------------------------------------------------
# Epoch-level LR schedules (host side; the reference's get_scheduler)
# ---------------------------------------------------------------------------


def linear_lr(epoch: int, lr: float, nepochs: int, nepochs_decay: int) -> float:
    """Constant for ``nepochs`` epochs, then linear decay to 0 over
    ``nepochs_decay`` (``epoch`` counts from 0)."""
    factor = 1.0 - max(0, epoch + 1 - nepochs) / float(nepochs_decay + 1)
    return lr * factor


def step_lr(epoch: int, lr: float, decay_iters: int, gamma: float = 0.1) -> float:
    return lr * (gamma ** (epoch // decay_iters))


def cosine_lr(epoch: int, lr: float, nepochs: int) -> float:
    return lr * 0.5 * (1.0 + math.cos(math.pi * (epoch % nepochs) / nepochs))


class PlateauLR:
    """ReduceLROnPlateau (mode='min', factor=0.2, threshold=0.01, patience=5)."""

    def __init__(self, lr: float, factor: float = 0.2, threshold: float = 0.01,
                 patience: int = 5):
        self.lr = lr
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


def schedule_lr(policy: str, epoch: int, lr: float, *, nepochs: int = 100,
                nepochs_decay: int = 100, lr_decay_iters: int = 50,
                plateau: Optional[PlateauLR] = None) -> float:
    if policy == "linear":
        return linear_lr(epoch, lr, nepochs, nepochs_decay)
    if policy == "step":
        return step_lr(epoch, lr, lr_decay_iters)
    if policy == "cosine":
        return cosine_lr(epoch, lr, nepochs)
    if policy == "plateau":
        # stateful: the Trainer owns a PlateauLR and feeds it the eval metric
        # once per epoch
        if plateau is None:
            raise ValueError("lr_policy 'plateau' is stateful: pass the PlateauLR "
                             "tracker (the Trainer does this)")
        return plateau.lr
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
