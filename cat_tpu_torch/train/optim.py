"""Adam with the JAX package's semantics (port of ``cat_tpu/train/optim.py``;
the LR schedules are not ported yet).

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

from typing import Iterable, List, Sequence

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

