"""The SPADE (GauGAN) teacher-training task (port of
``cat_tpu/train/spade_model.py``).

Reference: models/spade_model.py and
modules/spade_modules/spade_model_modules.py.  As in the JAX package:

  * input preprocessing on the device: label ids -> one-hot semantics (+ the
    dontcare channel) + the instance-boundary channel
    (spade_model.py:142-179);
  * TTUR: G at lr/2, D at 2·lr, Adam betas (0, 0.9), unless ``no_TTUR``
    (spade_model_modules.py:52-65);
  * G loss = hinge GAN + feature matching (λ_feat / num_D over every
    intermediate D feature) + VGG perceptual (λ_vgg)
    (spade_model_modules.py:93-134);
  * fake and real go through D once, concatenated, and are split
    (discriminate / divide_pred :136-155);
  * G updates first, against the old D, whose spectral ``u`` that forward
    leaves alone; G's forward moves its batch-norm running statistics.  The
    D step regenerates the fake from the *updated* G in train mode without a
    gradient, leaving G's statistics alone, and writes D's ``u``
    (spade_model.py:207-215, spade_model_modules.py:118-126).

Over a split height (``--n_spatial``, ``parallel/spatial.py``) the label
and instance maps stay whole on every rank (the loader cuts only the
photos' rows): the one-hot semantics and the instance edges are the
single-device ones, with no halo; the generators read them whole, D's
input takes the rank's rows of them (``d_input``), and the losses are means
over the global tensors.

``compute_dtype`` "bfloat16" runs G's forwards and the D step in bf16 with
float32 masters; the G step's D forward runs in float32 on bf16-rounded
inputs, as the JAX package's mixed-dtype convs promote.  Entry points run
on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig, SPADEGeneratorConfig
from cat_tpu_torch.models.losses import gan_loss
from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator
from cat_tpu_torch.models.vgg import VGG19Features, vgg_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.parallel import collectives, spatial
from cat_tpu_torch.train.common import (GANTrainState, Precision, average_grads, checkpointed,
                                        global_metrics, net_state)

# ---------------------------------------------------------------------------
# input preprocessing (reference spade_model.preprocess_input:142-161)
# ---------------------------------------------------------------------------


def _maps(t: torch.Tensor) -> torch.Tensor:
    """(N, H, W) from (N, H, W) or (N, 1, H, W)."""
    return t[:, 0] if t.dim() == 4 else t


def one_hot_semantics(label: torch.Tensor, n_labels: int) -> torch.Tensor:
    """Integer label maps -> one-hot NCHW float32; an id outside
    [0, n_labels) gives a zero vector, as ``jax.nn.one_hot`` does."""
    ids = torch.arange(n_labels, device=label.device)[None, :, None, None]
    return (_maps(label).long()[:, None] == ids).float()


def instance_edges(inst: torch.Tensor) -> torch.Tensor:
    """Instance-boundary map (N, 1, H, W): a pixel whose right, left, lower
    or upper neighbour has another instance id (reference get_edges,
    spade_model.py:169-179)."""
    inst = _maps(inst)
    e = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    dx = inst[:, :, 1:] != inst[:, :, :-1]
    e[:, :, 1:] |= dx
    e[:, :, :-1] |= dx
    dy = inst[:, 1:, :] != inst[:, :-1, :]
    e[:, 1:, :] |= dy
    e[:, :-1, :] |= dy
    return e.float()[:, None]


def preprocess_input(label: torch.Tensor, instance: Optional[torch.Tensor], label_nc: int,
                     contain_dontcare_label: bool = False) -> torch.Tensor:
    """label (+ instance) maps -> the generator's NCHW semantics.  With
    ``contain_dontcare_label`` every id >= label_nc (the void 255) maps to an
    extra last channel."""
    lab = _maps(label).long()
    if contain_dontcare_label:
        lab = torch.where(lab >= label_nc, torch.full_like(lab, label_nc), lab)
    sem = one_hot_semantics(lab, label_nc + (1 if contain_dontcare_label else 0))
    if instance is not None:
        sem = torch.cat([sem, instance_edges(instance)], 1)
    return sem


# ---------------------------------------------------------------------------
# hyper-parameters and the task
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SPADEHParams:
    gan_mode: str = "hinge"
    lambda_gan: float = 1.0
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_TTUR: bool = False
    beta1: float = 0.0
    beta2: float = 0.9
    init_type: str = "xavier"
    init_gain: float = 0.02
    compute_dtype: str = "float32"  # float32 | bfloat16 (float32 masters)
    vgg_compute_dtype: str = "float32"  # dtype of the VGG19 sweep
    remat: bool = False  # recompute the generator forward in the backward
    packed_blocks: bool = True  # G's branches packed (models/spade.py)


def feature_matching_loss(pred_fake, pred_real) -> torch.Tensor:
    """L1 over every intermediate D feature (the logits left out), the
    real's held constant, averaged over scales (spade_model_modules.py:100-112);
    over a split height, means over the global features."""
    num_d = len(pred_fake)
    total = torch.zeros((), device=pred_fake[0][0].device)
    for scale_f, scale_r in zip(pred_fake, pred_real):
        for f, r in zip(scale_f[:-1], scale_r[:-1]):
            total = total + spatial.mean((f - r.detach()).abs()) / num_d
    return total


def d_input(sem: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """D's input: the semantics beside an image.  Over a split height the
    semantics are whole on every rank (made from the whole label maps) and
    the image holds the rank's rows, so the semantics' rows are cut to
    match."""
    return torch.cat([collectives.local_height(sem), image], 1)


def discriminate(net_d, params, sem, fake, real):
    """D over fake and real, concatenated once, in train mode;
    (pred_fake, pred_real)."""
    both = torch.cat([d_input(sem, fake), d_input(sem, real)], 0)
    out = functional_call(net_d, params, (both,), {"train": True})
    half = sem.shape[0]
    return ([[t[:half] for t in scale] for scale in out],
            [[t[half:] for t in scale] for scale in out])


class SPADETask:
    def __init__(self, gen_cfg: SPADEGeneratorConfig,
                 disc_cfg: Optional[MultiscaleDiscriminatorConfig] = None,
                 hp: SPADEHParams = SPADEHParams(), vgg: Optional[VGG19Features] = None,
                 input_nc: Optional[int] = None, contain_dontcare: bool = False, device=None):
        """``vgg``: the perceptual loss's network (None: no VGG loss);
        ``input_nc``/``contain_dontcare``: how raw label batches become
        semantics."""
        self.device = resolve_device(device)
        self.gen_cfg = gen_cfg
        self.disc_cfg = disc_cfg or MultiscaleDiscriminatorConfig(
            input_nc=gen_cfg.semantic_nc + gen_cfg.output_nc)
        self.hp = hp
        self.prec = Precision(hp.compute_dtype)
        self.vgg = None if vgg is None else vgg.to(self.device)
        self.label_nc = input_nc or gen_cfg.semantic_nc
        self.contain_dontcare = contain_dontcare
        self.netG: Optional[SPADEGenerator] = None
        self.netD: Optional[MultiscaleDiscriminator] = None

    @property
    def lr_mults(self) -> Tuple[float, float]:
        """(G, D) learning-rate multipliers (TTUR)."""
        return (1.0, 1.0) if self.hp.no_TTUR else (0.5, 2.0)

    def init_state(self, seed: int = 0,
                   g_state_dict: Optional[Dict[str, torch.Tensor]] = None) -> GANTrainState:
        """Both networks from ``seed`` (G from ``g_state_dict`` where given)
        on the device, and the train state."""
        hp = self.hp
        gen = torch.Generator().manual_seed(seed)
        netG = SPADEGenerator(self.gen_cfg, hp.init_type, hp.init_gain, generator=gen,
                              packed_blocks=hp.packed_blocks)
        if g_state_dict is not None:
            netG.load_state_dict(g_state_dict)
        netD = MultiscaleDiscriminator(self.disc_cfg, hp.init_type, hp.init_gain, generator=gen)
        self.netG, self.netD = netG.to(self.device), netD.to(self.device)
        return GANTrainState(step=0, g=net_state(self.netG, hp.beta1, hp.beta2),
                             d=net_state(self.netD, hp.beta1, hp.beta2),
                             rng=torch.Generator(device=self.device).manual_seed(seed))

    def semantics(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The generator's input from a raw label (and instance) batch."""
        return preprocess_input(batch["label"], batch.get("instance"), self.label_nc,
                                self.contain_dontcare)

    def train_step(self, state: GANTrainState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One G-then-D step; updates ``state`` in place and returns it with
        the step's losses (0-d tensors)."""
        hp, prec = self.hp, self.prec
        sem, real_B = prec.inputs(self.semantics(batch)), batch["image"]
        lr_g, lr_d = lr * self.lr_mults[0], lr * self.lr_mults[1]

        # --- G update against the old D ---
        def g_forward():
            return prec.outputs(functional_call(self.netG, prec.params(state.g.params, self.netG),
                                                (sem,), {"train": True}))

        fake = checkpointed(g_forward, self.netG, state.rng) if hp.remat else g_forward()
        d_frozen = {k: v.detach() for k, v in state.d.params.items()}
        with frozen_stats(self.netD):
            pred_fake, pred_real = discriminate(self.netD, d_frozen, prec.outputs(sem),
                                                prec.outputs(prec.inputs(fake)),
                                                prec.outputs(prec.inputs(real_B)))
        l_gan = gan_loss(pred_fake, True, hp.gan_mode, False) * hp.lambda_gan
        l_feat = feature_matching_loss(pred_fake, pred_real) * hp.lambda_feat
        if self.vgg is not None and hp.lambda_vgg > 0:
            l_vgg = vgg_loss(self.vgg, fake, real_B, hp.vgg_compute_dtype) * hp.lambda_vgg
        else:
            l_vgg = torch.zeros((), device=self.device)
        rng_now = state.rng.get_state()
        g_grads = torch.autograd.grad(l_gan + l_feat + l_vgg, list(state.g.params.values()))
        state.rng.set_state(rng_now)  # a remat recompute rewound it
        state.g.opt.step(average_grads(g_grads), lr_g)

        # --- D update: the fake regenerated by the updated G, no gradient ---
        with torch.no_grad(), frozen_stats(self.netG):
            fake = functional_call(self.netG, prec.params(state.g.params, self.netG), (sem,),
                                   {"train": True})
        pred_fake, pred_real = discriminate(self.netD, prec.params(state.d.params, self.netD),
                                            sem, fake, prec.inputs(real_B))
        l_d_fake = gan_loss(prec.outputs(pred_fake), False, hp.gan_mode, True)
        l_d_real = gan_loss(prec.outputs(pred_real), True, hp.gan_mode, True)
        d_grads = torch.autograd.grad(l_d_fake + l_d_real, list(state.d.params.values()))
        state.d.opt.step(average_grads(d_grads), lr_d)

        state.step += 1
        metrics = {"G_loss/gan": l_gan, "G_loss/feat": l_feat, "G_loss/vgg": l_vgg,
                   "D_loss/fake": l_d_fake, "D_loss/real": l_d_real}
        return state, global_metrics(metrics)

    @torch.no_grad()
    def generate(self, state: GANTrainState, sem: torch.Tensor) -> torch.Tensor:
        """G in eval mode (running statistics) on semantics."""
        return self.netG(sem)

    @torch.no_grad()
    def generate_raw(self, state: GANTrainState, batch: Dict) -> torch.Tensor:
        """G in eval mode on a raw label (and instance) batch on the device:
        what the FID and mIoU evaluators call (reference
        spade_model.evaluate_model:217-288)."""
        return self.generate(state, self.semantics(batch))
