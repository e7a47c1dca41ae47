"""Training-state containers and the mixed-precision cast (port of
``cat_tpu/train/common.py``).

The JAX package threads an immutable state pytree through a jitted step.
Here the state holds the networks' own parameter tensors (float32 masters)
and their optimisers, and a step updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

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
    g: NetState
    d: NetState
    rng: torch.Generator  # dropout masks
