"""The comparison that decides ``correct`` for a training cell.

Both sides report, for the first steps of one training state: each step's
losses, each parameter leaf's first gradient (the program's as its
optimiser got it, read from Adam's first moment after one step) and each
leaf's change after the steps.  Leaves are named ``G:<name>`` and
``D:<name>``.  The numbers compared:

* ``loss_gap``: the widest gap of the first step's loss terms, each against
  the reference's term or 1, whichever is larger (a hinge GAN term is a mean
  logit, which crosses nought, where a gap relative to it means nothing),
  leaving out the terms that the step computes after an optimiser update
  (the family's ``AFTER_UPDATE``): Adam's first update is a step of lr
  along the gradient's sign, so an element whose gradient is near nought
  moves either way with rounding, and a loss read through it swings from
  seed to seed (``loss_gap_all``, every term of every step, is reported
  beside it with no limit);
* ``grad_gap.G``, ``grad_gap.D``: each leaf's gap between the two sides'
  norms of the first gradient, against the reference's norm of that leaf or
  of the median leaf of its network, whichever is larger; the median leaf's
  gap, taken in each network apart (G with its adaptors; D, whose few
  leaves a median over both networks would never reach);
* ``change_gap.G``, ``change_gap.D``: the same for the parameters' change
  after the steps, leaving out the leaves whose reference gradient is under
  a thousandth of their network's median leaf (a conv bias under an
  instance norm: its gradient is round-off, and Adam moves it by round-off
  alone).

The worst leaf's gap (``grad_worst``, ``change_worst``) is reported beside
them and compared with no limit: the leaves whose gradient an instance norm
cancels to first order (a conv's bias, a 1x1 depthwise conv's weight, both
ahead of the norm) read their round-off there, which differs by seed and
by precision alone.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

# a leaf whose first gradient is under this share of its net's median is
# round-off in the reference
NOUGHT_SHARE = 1e-3


def _nets(names) -> List[str]:
    return sorted({n.split(":", 1)[0] for n in names})


def _by_net(values: Dict[str, float], keep=None) -> Dict[str, float]:
    return {net: median([v for k, v in values.items() if k.startswith(net + ":")
                         and (keep is None or k in keep)] or [0.0])
            for net in _nets(values)}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap between the sides' norms, against the larger of
    the reference's norm of the leaf and of its network's median leaf."""
    med = _by_net(ref, keep)
    gaps = {}
    for k in keep:
        p = prog.get(k, math.nan)
        den = max(ref[k], med[k.split(":", 1)[0]])
        if not math.isfinite(p):
            gaps[k] = math.inf
        elif den > 0:
            gaps[k] = abs(p - ref[k]) / den
        else:
            gaps[k] = 0.0 if p == 0 else math.inf
    return gaps


def _median_by_net(gaps: Dict[str, float], name: str) -> Dict[str, float]:
    """``name.<net>``: each network's median leaf gap."""
    return {f"{name}.{net}": v for net, v in _by_net(gaps).items()}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], keep, top: int = 4):
    """The ``top`` leaves of the largest gap (name, program, reference):
    what a reading's look starts from."""
    med = _by_net(ref, keep)
    gaps = sorted(keep, key=lambda k: -abs(prog.get(k, math.inf) - ref[k])
                  / max(ref[k], med[k.split(":", 1)[0]], 1e-30))
    return [(k, prog.get(k), ref[k]) for k in gaps[:top]]


def moving_leaves(ref_first_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is more than round-off."""
    med = _by_net(ref_first_grad)
    return [k for k, v in ref_first_grad.items() if v >= NOUGHT_SHARE * med[k.split(":", 1)[0]]]


def _loss_gap(p_step: Dict[str, float], r_step: Dict[str, float], skip=()) -> float:
    worst = 0.0
    for k, r in r_step.items():
        if k in skip:
            continue
        gap = abs(p_step.get(k, math.nan) - r) / max(abs(r), 1.0)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def training_gaps(prog: Dict, ref: Dict, after_update=()) -> Dict[str, float]:
    """The numbers compared (and the diagnostics beside them) of the
    program's record against the reference's; ``after_update`` names the
    first step's loss terms read through an updated network."""
    steps = len(ref["losses"])
    if prog is None or len(prog["losses"]) != steps:
        return {"loss_gap": math.inf, "loss_gap_all": math.inf, "grad_worst": math.inf,
                "change_worst": math.inf}
    loss_gap = _loss_gap(prog["losses"][0], ref["losses"][0], after_update)
    loss_all = max(_loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"]))
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"], list(ref["first_grad"]))
    change = leaf_gaps(prog["change"], ref["change"], moving_leaves(ref["first_grad"]))
    return {"loss_gap": loss_gap, "loss_gap_all": loss_all,
            **_median_by_net(grad, "grad_gap"), **_median_by_net(change, "change_gap"),
            "grad_worst": max(grad.values()), "change_worst": max(change.values())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
