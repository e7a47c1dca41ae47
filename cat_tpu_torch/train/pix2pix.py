"""pix2pix task: conditional PatchGAN + reconstruction loss (port of
``cat_tpu/train/pix2pix.py``).

Reference: models/pix2pix_model.py (losses 156-196, D-then-G update order
198-207).  One ``train_step``:

  1. the generator runs forward once (dropout on, batch statistics, its
     running statistics moved); its graph is kept for the G update (with
     ``remat`` only its input, and ``torch.utils.checkpoint`` recomputes it);
  2. D updates on (A, fake) then (A, real), 0.5·(fake + real), both
     forwards moving D's running statistics, plus the gradient penalty under
     wgangp (its forward leaves them alone);
  3. G updates *through the freshly updated D* (whose statistics that
     forward leaves alone): λ_gan·GAN + λ_recon·recon.

Float32 throughout, as the JAX task; entry points run on CUDA unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
from cat_tpu_torch.models.discriminators import NLayerDiscriminator, check_task_discriminator
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.models.losses import gan_loss, gradient_penalty, recon_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.train.common import (GANTrainState, average_grads, checkpointed,
                                        global_metrics, net_state)


@dataclass(frozen=True)
class Pix2PixHParams:
    gan_mode: str = "hinge"
    recon_loss_type: str = "l1"
    lambda_gan: float = 1.0
    lambda_recon: float = 100.0
    beta1: float = 0.5
    init_type: str = "normal"
    init_gain: float = 0.02
    packed_blocks: bool = True  # branch-packed inception blocks (same math)
    remat: bool = False  # recompute the generator forward in the backward


class Pix2PixTask:
    def __init__(self, gen_cfg: InceptionGeneratorConfig,
                 disc_cfg: Optional[NLayerDiscriminatorConfig] = None,
                 hp: Pix2PixHParams = Pix2PixHParams(), device=None):
        check_task_discriminator(disc_cfg)
        self.device = resolve_device(device)
        self.gen_cfg = gen_cfg
        self.disc_cfg = disc_cfg or NLayerDiscriminatorConfig(
            input_nc=gen_cfg.input_nc + gen_cfg.output_nc)
        self.hp = hp
        self.netG: Optional[InceptionGenerator] = None
        self.netD: Optional[NLayerDiscriminator] = None

    def init_state(self, seed: int = 0,
                   g_state_dict: Optional[Dict[str, torch.Tensor]] = None) -> GANTrainState:
        """Build both networks from ``seed`` (G from ``g_state_dict`` where
        given) on the device, and the train state."""
        hp = self.hp
        gen = torch.Generator().manual_seed(seed)
        netG = InceptionGenerator(self.gen_cfg, hp.init_type, hp.init_gain,
                                  packed_blocks=hp.packed_blocks, generator=gen)
        if g_state_dict is not None:
            netG.load_state_dict(g_state_dict)
        netD = NLayerDiscriminator(self.disc_cfg, hp.init_type, hp.init_gain, generator=gen)
        self.netG, self.netD = netG.to(self.device), netD.to(self.device)
        return GANTrainState(
            step=0,
            g=net_state(self.netG, hp.beta1),
            d=net_state(self.netD, hp.beta1),
            rng=torch.Generator(device=self.device).manual_seed(seed),
        )

    def train_step(self, state: GANTrainState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One D-then-G step; updates ``state`` in place and returns it with
        the step's losses (0-d tensors)."""
        hp = self.hp
        real_A, real_B = batch["A"], batch["B"]

        # --- generator forward once, graph kept ---
        def g_forward():
            return self.netG(real_A, train=True, generator=state.rng)

        fake_B = checkpointed(g_forward, self.netG, state.rng) if hp.remat else g_forward()

        # --- discriminator update (reference backward_D: 160-175) ---
        d_params = state.d.params
        fake_pair = torch.cat([real_A, fake_B.detach()], 1)
        real_pair = torch.cat([real_A, real_B], 1)
        l_d_fake = gan_loss(self.netD(fake_pair, train=True), False, hp.gan_mode, True)
        l_d_real = gan_loss(self.netD(real_pair, train=True), True, hp.gan_mode, True)
        d_loss = 0.5 * (l_d_fake + l_d_real)
        if hp.gan_mode == "wgangp":
            # the JAX package applies the Lipschitz penalty the reference
            # defines and never calls
            with frozen_stats(self.netD):
                l_d_gp, _ = gradient_penalty(lambda x: self.netD(x, train=True), real_pair,
                                             fake_pair, generator=state.rng)
            d_loss = d_loss + l_d_gp
        state.d.opt.step(average_grads(torch.autograd.grad(d_loss, list(d_params.values()))),
                         lr)

        # --- generator update through the updated discriminator ---
        with frozen_stats(self.netD):
            pred = self.netD(torch.cat([real_A, fake_B], 1), train=True)
        l_g_gan = gan_loss(pred, True, hp.gan_mode, False) * hp.lambda_gan
        l_g_rec = recon_loss(fake_B, real_B, hp.recon_loss_type) * hp.lambda_recon
        rng_now = state.rng.get_state()
        g_grads = torch.autograd.grad(l_g_gan + l_g_rec, list(state.g.params.values()))
        state.rng.set_state(rng_now)  # a remat recompute rewound it
        state.g.opt.step(average_grads(g_grads), lr)

        state.step += 1
        metrics = {"G_loss/gan": l_g_gan, "G_loss/recon": l_g_rec,
                   "D_loss/fake": l_d_fake, "D_loss/real": l_d_real}
        if hp.gan_mode == "wgangp":
            metrics["D_loss/gp"] = l_d_gp
        return state, global_metrics(metrics)

    @torch.no_grad()
    def generate(self, state: GANTrainState, x: torch.Tensor) -> torch.Tensor:
        """G in eval mode: running statistics where tracked, no dropout."""
        return self.netG(x)
