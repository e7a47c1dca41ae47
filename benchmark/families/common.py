"""What the families share: seeded weights made on the device, the check
steps of one training state, the window's step, and the faults planted in
a program's step for the checks of the check."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

CHECK_STEPS = 3


def _scale_values(total: int) -> torch.Tensor:
    """The fixed set of γ values every seed orders: uniform in [0.05, 2)
    from a fixed stream, as CAT's benchmark spreads a fresh teacher's."""
    rs = np.random.RandomState(0)
    return torch.from_numpy(rs.uniform(0.05, 2.0, total).astype(np.float32))


def seeded_weights(shapes: Dict, gen: torch.Generator, device, spread: bool,
                   std: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """Weights and buffers for ``shapes`` (name -> (shape, kind), a
    reference module's layout) in a few calls on the device: kernels N(0,
    0.02) in one draw (``std[name]`` where given); biases, β and running
    means zero; running variances and γ one, or with ``spread`` each norm
    layer's γ a seeded ordering of a fixed set, so that every seed shrinks
    to the same student; spectral ``u`` seeded unit vectors, ``v`` =
    l2norm(Wᵀu)."""
    std = std or {}
    out: Dict[str, torch.Tensor] = {}

    def of(kind):
        return [k for k, (_, kd) in shapes.items() if kd == kind]

    kernels = of("conv")
    sizes = [math.prod(shapes[k][0]) for k in kernels]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for k, v in zip(kernels, flat.split(sizes)):
        out[k] = v.view(shapes[k][0]) * std.get(k, 0.02)
    scales = of("scale")
    ssz = [shapes[k][0][0] for k in scales]
    if spread and scales:
        # one sort orders every layer's values: keys in [0, 1) plus the layer index
        layer = torch.repeat_interleave(torch.arange(len(ssz), device=device),
                                        torch.tensor(ssz, device=device))
        order = (torch.rand(sum(ssz), generator=gen, device=device) + layer).argsort()
        gam = _scale_values(sum(ssz)).to(device)[order]
    else:
        gam = torch.ones(sum(ssz), device=device)
    out.update(zip(scales, gam.split(ssz)))
    for kind, fill in (("bias", 0.0), ("shift", 0.0), ("mean", 0.0), ("var", 1.0)):
        names = of(kind)
        if names:
            sz = [shapes[k][0][0] for k in names]
            out.update(zip(names, torch.full((sum(sz),), fill, device=device).split(sz)))
    us = of("u")
    if us:
        usz = [shapes[k][0][0] for k in us]
        for k, u in zip(us, torch.randn(sum(usz), generator=gen, device=device).split(usz)):
            out[k] = u / (u.norm() + 1e-12)
            w = out[k[:-len("weight_u")] + "weight_orig"]
            v = w.reshape(w.shape[0], -1).t() @ out[k]
            out[k[:-len("weight_u")] + "weight_v"] = v / (v.norm() + 1e-12)
    return {k: out[k] for k in shapes}


class TrainingCell:
    """One cell's program state: a family sets ``config`` (with ``beta1``),
    ``bank``, ``lr``, ``dist``, ``state`` and ``tparams``; ``record`` holds
    what its first steps gave."""

    dist = state = tparams = record = None

    def _leaves(self) -> Dict[str, torch.Tensor]:
        return {**{f"G:{k}": v for k, v in self.state.g.params.items()},
                **{f"D:{k}": v for k, v in self.state.d.params.items()}}

    def check_steps(self) -> Dict:
        """The first steps, on bank batches 0, 1, 2, through the window's
        own call: each step's losses, the first gradient as Adam got it (its
        first moment after one step is (1 - β1)·g), and every leaf's change
        after the steps."""
        start = {k: v.detach().clone() for k, v in self._leaves().items()}
        losses, first = [], {}
        b1 = self.config["beta1"]
        for i in range(CHECK_STEPS):
            self.state, m = self.dist.train_step(self.state, self.tparams, self.bank[i], self.lr)
            losses.append({k: float(v) for k, v in m.items()})
            if i == 0:
                for net, opt, params in (("G", self.state.g.opt, self.state.g.params),
                                         ("D", self.state.d.opt, self.state.d.params)):
                    for name, mu in zip(params, opt.mu):
                        first[f"{net}:{name}"] = float(mu.double().norm()) / (1.0 - b1)
        change = {k: float((v.detach() - start[k]).double().norm())
                  for k, v in self._leaves().items()}
        return {"losses": losses, "first_grad": first, "change": change}

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        """Window step i: the distiller's step on the next bank batch."""
        batch = self.bank[(CHECK_STEPS + i) % len(self.bank)]
        self.state, metrics = self.dist.train_step(self.state, self.tparams, batch, self.lr)
        return metrics

    def free(self) -> None:
        """Drop the program's state (the bank and the seeded weights stay)."""
        self.dist = self.state = self.tparams = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@contextlib.contextmanager
def _patched(owner, attr, fn):
    saved = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def fault(name: str, distiller, generator):
    """A context within which the program's step has fault ``name``:
    ``unchanged`` (the optimiser writes no parameter), ``unchanged_d`` (D's
    optimiser writes none of D's: G trains against a D left as it was
    seeded), ``half_batch`` (the
    step sees the first half of each batch, its means over that half) or
    ``altered`` (the student's image scaled by 0.9 where ``generator``
    produces it in train mode, as a wrong output scale would)."""
    from cat_tpu_torch.train.optim import Adam

    if name == "unchanged":
        return _patched(Adam, "step", lambda self, grads, lr: None)
    if name == "unchanged_d":
        step = distiller.train_step

        def d_frozen(self, state, tparams, batch, lr):
            state.d.opt.step = lambda grads, lr: None  # this state's D optimiser alone
            return step(self, state, tparams, batch, lr)
        return _patched(distiller, "train_step", d_frozen)
    if name == "half_batch":
        step = distiller.train_step

        def half(self, state, tparams, batch, lr):
            return step(self, state, tparams, {k: v[:v.shape[0] // 2] for k, v in batch.items()},
                        lr)
        return _patched(distiller, "train_step", half)
    if name == "altered":
        forward = generator.forward

        def scaled(self, x, *args, **kwargs):
            out = forward(self, x, *args, **kwargs)
            if not kwargs.get("train", args[0] if args else False):
                return out
            return (out[0] * 0.9, out[1]) if isinstance(out, tuple) else out * 0.9
        return _patched(generator, "forward", scaled)
    raise ValueError(f"unknown fault {name!r}")
