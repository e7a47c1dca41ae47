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

from cat_tpu_torch import DTYPES, import_stdlib_profile
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.ops.spectral import SpectralConv2d
from cat_tpu_torch.parallel import collectives
from cat_tpu_torch.train.optim import Adam
from cat_tpu_torch.utils.image_pool import ImagePool


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Cast a float tensor, or the float tensors of a (nested) dict or
    list, to a compute dtype.  The casts are part of the autograd graph, so
    gradients come back to float32 masters in float32."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_floats(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class _FlatCast(torch.autograd.Function):
    """Tensors of one dtype cast to another as one flat tensor: concatenated,
    cast and split, so a few launches cast them all; the backward brings
    their gradients back to the inputs' dtype the same way."""

    @staticmethod
    def forward(ctx, dtype, *ts):
        ctx.src, ctx.shapes = ts[0].dtype, [t.shape for t in ts]
        ctx.sizes = [t.numel() for t in ts]
        flat = torch.cat([t.reshape(-1) for t in ts]).to(dtype)
        return tuple(o.view(s) for o, s in zip(flat.split(ctx.sizes), ctx.shapes))

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs]).to(ctx.src)
        return (None, *(o.view(s) for o, s in zip(flat.split(ctx.sizes), ctx.shapes)))


def cast_flat(params: Dict[str, torch.Tensor], dtype: torch.dtype,
              keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """``cast_floats`` of a flat dict of parameters, the same values, with
    the float32 ones cast together (``_FlatCast``: a few launches rather
    than one a tensor); the tensors named in ``keep`` stay as they are."""
    out = {k: v if k in keep else cast_floats(v, dtype) for k, v in params.items()
           if v.dtype != torch.float32 or k in keep}
    names = [k for k in params if k not in out]
    if names:
        out.update(zip(names, _FlatCast.apply(dtype, *(params[k] for k in names))))
    return {k: out[k] for k in params}


class Precision:
    """A step's mixed precision, placed as in the JAX package rather than
    by ``torch.autocast``: float32 masters; parameters (``params``) and
    inputs (``inputs``) cast to the compute dtype inside the forward, so
    autograd brings float32 gradients back; network outputs cast to
    float32 for the losses (``outputs``); taps (``taps``) kept in the
    compute dtype for KA and cast to float32 for the mse adaptors.  Under
    float32 nothing is cast."""

    def __init__(self, name: str, distill_loss_type: str = "ka"):
        if name not in DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}")
        self.dtype = DTYPES[name]
        self.mixed = self.dtype != torch.float32
        self.ka = distill_loss_type == "ka"
        self._keep: Dict[torch.nn.Module, frozenset] = {}

    def params(self, params: Dict[str, torch.Tensor],
               net: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """``net``'s parameters in the compute dtype, in one flat cast
        (``cast_flat``) but for those ``net.float32_params()`` names, which
        stay float32 masters (ADM's norms)."""
        if not self.mixed:
            return params
        if net not in self._keep:
            self._keep[net] = frozenset(getattr(net, "float32_params", tuple)())
        return cast_flat(params, self.dtype, self._keep[net])

    def inputs(self, tree: Any) -> Any:
        return cast_floats(tree, self.dtype) if self.mixed else tree

    def outputs(self, tree: Any) -> Any:
        return cast_floats(tree, torch.float32) if self.mixed else tree

    def taps(self, acts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return acts if self.ka else self.outputs(acts)


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


def net_state(net: torch.nn.Module, beta1: float, beta2: float = 0.999,
              extra: Sequence[torch.Tensor] = ()) -> NetState:
    """A network's parameters, an Adam over them (and after them over
    ``extra``, the adaptors of the JAX package's {G, A} group), and its
    running statistics, all the module's own tensors."""
    params = dict(net.named_parameters())
    return NetState(params, Adam([*params.values(), *extra], beta1, beta2),
                    dict(net.named_buffers()))


def ema_extra(params: Dict[str, torch.Tensor], decay: float) -> Dict[str, Any]:
    """``GANTrainState.extra``: under an EMA (``decay`` > 0) ``ema_G``, a
    copy of the student's ``params``; else empty."""
    return {"ema_G": {k: v.detach().clone() for k, v in params.items()}} if decay > 0 else {}


@torch.no_grad()
def update_ema(state: GANTrainState, decay: float) -> None:
    """ema_G <- decay * ema_G + (1 - decay) * G, after a G step; nothing
    without an EMA."""
    if decay > 0:
        ema = list(state.extra["ema_G"].values())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(list(state.g.params.values()), 1.0 - decay))


def student_eval_params(state: GANTrainState) -> Dict[str, torch.Tensor]:
    """The EMA weights under an EMA, else the trained weights: what
    evaluation and deployment use."""
    return state.extra.get("ema_G", state.g.params)


_BUCKET_BYTES = 64 << 20  # a flattened all-reduce's size


def average_grads(grads: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The gradients averaged over the ranks (of ``group``, the default
    group when None): all-reduced in flattened buckets of up to 64 MiB a
    dtype and divided by the world size.  Each rank's objective is scaled
    so that the ranks' objectives sum to the world size times the global
    batch's loss (a mean over the rank's equal share of the batch; over a
    split height, ``parallel/spatial.py::mean``'s share of it), and the
    collectives' backwards bring every rank the gradient of that sum
    through its own tensors, so the average is the gradient of the global
    batch's loss.  Without a group, ``grads`` as they are.  The steps call
    it before every optimiser step (no DDP: the steps are functional, D
    runs several forwards an update, and remat recomputes the forward)."""
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
