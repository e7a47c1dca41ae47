"""Training-state containers and the mixed-precision cast (port of
``cat_tpu/train/common.py``).

The JAX package threads an immutable state pytree through a jitted step.
Here the state holds the networks' own parameter tensors (float32 masters)
and their optimisers, and a step updates them in place.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from cat_tpu_torch import import_stdlib_profile
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.ops.spectral import SpectralConv2d
from cat_tpu_torch.parallel import collectives
from cat_tpu_torch.train.optim import Adam
from cat_tpu_torch.utils.image_pool import ImagePool


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast a float tensor, or the float tensors of a (nested) dict, to a
    compute dtype.  The casts are part of the autograd graph, so gradients
    come back to float32 masters in float32."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@dataclass
class NetState:
    """Parameters (name -> float32 tensor), their optimiser, and the
    networks' batch-norm running statistics (name -> buffer; empty when no
    norm tracks them).  The tensors are the modules' own, so a step updates
    them in place."""

    params: Dict[str, torch.Tensor]
    opt: Adam
    stats: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class GANTrainState:
    step: int
    g: NetState  # its optimiser also updates ``adaptors``, after the student's
    d: NetState
    rng: torch.Generator  # dropout masks
    adaptors: Dict[str, torch.Tensor] = field(default_factory=dict)  # mse distillation
    extra: Dict[str, Any] = field(default_factory=dict)  # e.g. {"ema_G": params}
    pools: Dict[str, ImagePool] = field(default_factory=dict)  # CycleGAN: fake_A, fake_B


def net_state(net: torch.nn.Module, beta1: float) -> NetState:
    """A network's parameters, an Adam over them, and its running
    statistics, all the module's own tensors."""
    params = dict(net.named_parameters())
    return NetState(params, Adam(params.values(), beta1), dict(net.named_buffers()))


_BUCKET_BYTES = 64 << 20  # a flattened all-reduce's size


def average_grads(grads: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The gradients averaged over the ranks (of ``group``, the default
    group when None): all-reduced in flattened buckets of up to 64 MiB a
    dtype and divided by the world size.  Each rank's losses are means over
    its equal share of the global batch, so the average is the gradient of
    the global batch's loss.  Without a group, ``grads`` as they are.  The
    steps call it before every optimiser step (no DDP: the steps are
    functional, D runs several forwards an update, and remat recomputes
    the forward)."""
    grads = list(grads)
    if not collectives.active():
        return grads
    world = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in collectives.buckets(grads, _BUCKET_BYTES):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for i, g in zip(idx, collectives.unflatten(flat, [grads[i] for i in idx])):
            out[i] = g
    return out


def global_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's metrics (0-d tensors) detached and averaged over the ranks,
    in one all-reduce: every rank reports the global batch's means, as the
    JAX package's hosts do."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not collectives.active() or not metrics:
        return metrics
    return dict(zip(metrics, average_grads([v.float() for v in metrics.values()])))


def checkpointed(fn, net: torch.nn.Module, rng: torch.Generator, policy=None):
    """``fn()`` under ``torch.utils.checkpoint``: only its inputs are kept,
    and the backward recomputes it with the same dropout masks, from the
    spectral ``u`` the first forward started from, and without writing
    ``net``'s running statistics or ``u`` a second time.  The recompute
    rewinds ``rng``: keep its state around the backward.  ``policy``, an
    op policy of ``create_selective_checkpoint_contexts``, keeps the
    outputs of the ops it saves, which the recompute then reads instead of
    running them (selective checkpointing); None keeps nothing.  The
    rewinds happen outside the selective context, so that the recompute
    runs no op the first forward did not run."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    import_stdlib_profile()  # torch.utils.checkpoint reaches TorchDynamo
    start = rng.get_state()
    spectral = [m for m in net.modules() if isinstance(m, SpectralConv2d)]
    u_start = [m.weight_u.clone() for m in spectral]

    @contextmanager
    def rewound(selective):
        rng.set_state(start)
        u_now = [m.weight_u.clone() for m in spectral]
        with torch.no_grad():
            for m, u in zip(spectral, u_start):
                m.weight_u.copy_(u)
        try:
            with frozen_stats(net), selective:
                yield
        finally:
            with torch.no_grad():
                for m, u in zip(spectral, u_now):
                    m.weight_u.copy_(u)

    def contexts():
        if policy is None:
            return nullcontext(), rewound(nullcontext())
        first, again = create_selective_checkpoint_contexts(policy)
        return first, rewound(again)

    return checkpoint(fn, use_reentrant=False, context_fn=contexts)


def _g_names(state: GANTrainState) -> List[str]:
    return [*state.g.params, *(f"A.{k}" for k in state.adaptors)]


def train_state_dict(state: GANTrainState) -> Dict[str, Any]:
    """Everything a resume needs, as a nested dict of tensors and ints:
    parameters, running statistics, Adam moments and counts, the step, the
    image pools and the dropout RNG."""
    return {
        "step": state.step,
        "g": {"params": state.g.params, "stats": state.g.stats,
              "opt": state.g.opt.state_dict(_g_names(state))},
        "d": {"params": state.d.params, "stats": state.d.stats,
              "opt": state.d.opt.state_dict(list(state.d.params))},
        "adaptors": state.adaptors,
        "extra": state.extra,
        "pools": {k: p.state_dict() for k, p in state.pools.items()},
        "rng": state.rng.get_state(),
    }


@torch.no_grad()
def load_train_state_dict(state: GANTrainState, sd: Dict[str, Any]) -> GANTrainState:
    """Restore ``train_state_dict``'s output into ``state`` in place (the
    dropout RNG only where ``sd`` has one).  A checkpoint without running
    statistics or pools loads into nets that have none."""

    def copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
        if dst.keys() != src.keys():
            raise ValueError(f"train state: {what} do not match the checkpoint's")
        for k, v in dst.items():
            v.copy_(src[k])

    copy(state.g.params, sd["g"]["params"], "G parameters")
    copy(state.d.params, sd["d"]["params"], "D parameters")
    copy(state.g.stats, sd["g"].get("stats", {}), "G running statistics")
    copy(state.d.stats, sd["d"].get("stats", {}), "D running statistics")
    copy(state.adaptors, sd["adaptors"], "adaptor parameters")
    pools = sd.get("pools", {})
    if state.pools.keys() != pools.keys():
        raise ValueError("train state: the image pools do not match the checkpoint's")
    for k, pool in state.pools.items():
        pool.load_state_dict(pools[k])
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
