"""Training-state containers and the mixed-precision cast (port of
``cat_tpu/train/common.py``).

The JAX package threads an immutable state pytree through a jitted step.
Here the state holds the networks' own parameter tensors (float32 masters)
and their optimisers, and a step updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from cat_tpu_torch.train.optim import Adam


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast a float tensor, or the float tensors of a (nested) dict, to a
    compute dtype.  The casts are part of the autograd graph, so gradients
    come back to float32 masters in float32."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@dataclass
class NetState:
    """Parameters (name -> float32 tensor) and their optimiser.  The JAX
    package also carries batch-norm statistics here; the port has no batch
    norm yet."""

    params: Dict[str, torch.Tensor]
    opt: Adam


@dataclass
class GANTrainState:
    step: int
    g: NetState  # its optimiser also updates ``adaptors``, after the student's
    d: NetState
    rng: torch.Generator  # dropout masks
    adaptors: Dict[str, torch.Tensor] = field(default_factory=dict)  # mse distillation
    extra: Dict[str, Any] = field(default_factory=dict)  # e.g. {"ema_G": params}


def _g_names(state: GANTrainState) -> List[str]:
    return [*state.g.params, *(f"A.{k}" for k in state.adaptors)]


def train_state_dict(state: GANTrainState) -> Dict[str, Any]:
    """Everything a resume needs, as a nested dict of tensors and ints:
    parameters, Adam moments and counts, the step and the dropout RNG."""
    return {
        "step": state.step,
        "g": {"params": state.g.params, "opt": state.g.opt.state_dict(_g_names(state))},
        "d": {"params": state.d.params, "opt": state.d.opt.state_dict(list(state.d.params))},
        "adaptors": state.adaptors,
        "extra": state.extra,
        "rng": state.rng.get_state(),
    }


@torch.no_grad()
def load_train_state_dict(state: GANTrainState, sd: Dict[str, Any]) -> GANTrainState:
    """Restore ``train_state_dict``'s output into ``state`` in place (the
    dropout RNG only where ``sd`` has one)."""

    def copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
        if dst.keys() != src.keys():
            raise ValueError(f"train state: {what} do not match the checkpoint's")
        for k, v in dst.items():
            v.copy_(src[k])

    copy(state.g.params, sd["g"]["params"], "G parameters")
    copy(state.d.params, sd["d"]["params"], "D parameters")
    copy(state.adaptors, sd["adaptors"], "adaptor parameters")
    if state.extra.keys() != sd["extra"].keys():
        raise ValueError("train state: the EMA setting does not match the checkpoint's")
    for k, tree in state.extra.items():
        copy(tree, sd["extra"][k], k)
    state.g.opt.load_state_dict(sd["g"]["opt"], _g_names(state))
    state.d.opt.load_state_dict(sd["d"]["opt"], list(state.d.params))
    if "rng" in sd:
        state.rng.set_state(sd["rng"])
    state.step = int(sd["step"])
    return state
