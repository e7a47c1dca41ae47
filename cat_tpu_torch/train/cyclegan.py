"""CycleGAN task: two generators, two PatchGAN discriminators and two image
pools (port of ``cat_tpu/train/cyclegan.py``).

Reference: models/cycle_gan_model.py (losses 267-290, G-first-then-D order
292-303, ImagePool buffers 177-178/257-265).  One ``train_step``:

  1. the full cycle (G_A, G_B) and, with ``lambda_identity`` > 0, the
     identity branches;
  2. the generators update against the *pre-update* discriminators; no
     forward of this half moves a running statistic (the JAX task never
     writes G's, and reads D's as they are);
  3. both pools mix the detached fakes with their history: over several
     ranks, the global batch's fakes, gathered, in one pool that every rank
     holds alike (its draws seeded alike), each rank keeping its rows;
  4. the discriminators update on the reals and the pooled fakes, each
     net's two forwards moving its running statistics (real, then fake),
     plus the gradient penalty under wgangp.

G_A maps A to B and G_B maps B to A; D_A judges the B domain and D_B the A
domain.  The nets of a kind sit in one ``ModuleDict`` ("A", "B"), one Adam
over each.  Float32 throughout, as the JAX task.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from cat_tpu_torch import resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
from cat_tpu_torch.models.discriminators import NLayerDiscriminator, check_task_discriminator
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.models.losses import gan_loss, gradient_penalty, recon_loss
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.parallel.collectives import all_gather_rows, local_rows
from cat_tpu_torch.train.common import (GANTrainState, average_grads, checkpointed,
                                        global_metrics, net_state)
from cat_tpu_torch.utils.image_pool import ImagePool


@dataclass(frozen=True)
class CycleGANHParams:
    gan_mode: str = "lsgan"
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5
    pool_size: int = 50
    beta1: float = 0.5
    init_type: str = "normal"
    init_gain: float = 0.02
    packed_blocks: bool = True  # branch-packed inception blocks (same math)
    remat: bool = False  # recompute each generator forward in the backward


class CycleGANTask:
    def __init__(self, gen_cfg: InceptionGeneratorConfig,
                 disc_cfg: Optional[NLayerDiscriminatorConfig] = None,
                 hp: CycleGANHParams = CycleGANHParams(), device=None):
        if gen_cfg.input_nc != gen_cfg.output_nc and hp.lambda_identity != 0.0:
            raise ValueError("the identity loss needs input_nc == output_nc")
        check_task_discriminator(disc_cfg)
        self.device = resolve_device(device)
        self.gen_cfg = gen_cfg
        self.disc_cfg = disc_cfg or NLayerDiscriminatorConfig(input_nc=gen_cfg.output_nc)
        self.hp = hp
        self.netG: Optional[nn.ModuleDict] = None
        self.netD: Optional[nn.ModuleDict] = None

    def init_state(self, height: int, width: int, seed: int = 0) -> GANTrainState:
        """Build the four networks from ``seed`` on the device, the pools of
        ``height`` x ``width`` images, and the train state."""
        hp = self.hp
        gen = torch.Generator().manual_seed(seed)
        self.netG = nn.ModuleDict({
            n: InceptionGenerator(self.gen_cfg, hp.init_type, hp.init_gain,
                                  packed_blocks=hp.packed_blocks, generator=gen)
            for n in "AB"}).to(self.device)
        self.netD = nn.ModuleDict({
            n: NLayerDiscriminator(self.disc_cfg, hp.init_type, hp.init_gain, generator=gen)
            for n in "AB"}).to(self.device)
        pools = {f"fake_{n}": ImagePool(hp.pool_size, c, height, width, self.device,
                                        seed=seed + i + 1)
                 for i, (n, c) in enumerate((("A", self.gen_cfg.input_nc),
                                             ("B", self.gen_cfg.output_nc)))}
        return GANTrainState(
            step=0,
            g=net_state(self.netG, hp.beta1),
            d=net_state(self.netD, hp.beta1),
            rng=torch.Generator(device=self.device).manual_seed(seed),
            pools=pools,
        )

    def train_step(self, state: GANTrainState, batch: Dict[str, torch.Tensor],
                   lr: float) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One G-then-D step; updates ``state`` in place and returns it with
        the step's losses (0-d tensors, the JAX task's names)."""
        hp = self.hp
        real_A, real_B = batch["A"], batch["B"]
        G, D = self.netG, self.netD

        def g(name, x):
            def fwd():
                return G[name](x, train=True, generator=state.rng)

            return checkpointed(fwd, G, state.rng) if hp.remat else fwd()

        # --- generator update against the old discriminators (reference 292-298) ---
        losses: Dict[str, torch.Tensor] = {}
        with frozen_stats(G, D):
            fake_B = g("A", real_A)
            rec_A = g("B", fake_B)
            fake_A = g("B", real_B)
            rec_B = g("A", fake_A)
            if hp.lambda_identity > 0:
                losses["G_loss/idt_A"] = (recon_loss(g("A", real_B), real_B, "l1")
                                          * hp.lambda_B * hp.lambda_identity)
                losses["G_loss/idt_B"] = (recon_loss(g("B", real_A), real_A, "l1")
                                          * hp.lambda_A * hp.lambda_identity)
            else:
                zero = torch.zeros((), device=real_A.device)
                losses["G_loss/idt_A"] = losses["G_loss/idt_B"] = zero
            losses["G_loss/gan_A"] = gan_loss(D["A"](fake_B, train=True), True, hp.gan_mode,
                                              False)
            losses["G_loss/gan_B"] = gan_loss(D["B"](fake_A, train=True), True, hp.gan_mode,
                                              False)
        losses["G_loss/cycle_A"] = recon_loss(rec_A, real_A, "l1") * hp.lambda_A
        losses["G_loss/cycle_B"] = recon_loss(rec_B, real_B, "l1") * hp.lambda_B
        rng_now = state.rng.get_state()
        g_grads = torch.autograd.grad(sum(losses.values()), list(state.g.params.values()))
        state.rng.set_state(rng_now)  # a remat recompute rewound it
        state.g.opt.step(average_grads(g_grads), lr)

        # --- replay pools (reference ImagePool.query): one pool over the
        # global batch's fakes, the same on every rank, each keeping its rows
        fake_B_mixed = local_rows(state.pools["fake_B"].query(all_gather_rows(fake_B.detach())))
        fake_A_mixed = local_rows(state.pools["fake_A"].query(all_gather_rows(fake_A.detach())))

        # --- discriminator update (reference backward_D_basic: 238-265) ---
        for name, real, fake in (("A", real_B, fake_B_mixed), ("B", real_A, fake_A_mixed)):
            net = D[name]
            pred_real = net(real, train=True)
            pred_fake = net(fake, train=True)
            losses[f"D_loss/{name}"] = 0.5 * (gan_loss(pred_real, True, hp.gan_mode, True)
                                              + gan_loss(pred_fake, False, hp.gan_mode, True))
            if hp.gan_mode == "wgangp":
                with frozen_stats(net):
                    losses[f"D_loss/gp_{name}"], _ = gradient_penalty(
                        lambda x, net=net: net(x, train=True), real, fake, generator=state.rng)
        d_loss = sum(v for k, v in losses.items() if k.startswith("D_loss/"))
        state.d.opt.step(average_grads(torch.autograd.grad(d_loss, list(state.d.params.values()))),
                         lr)

        state.step += 1
        return state, global_metrics(losses)

    @torch.no_grad()
    def generate(self, state: GANTrainState, x: torch.Tensor,
                 direction: str = "AtoB") -> torch.Tensor:
        """G_A (AtoB) or G_B in eval mode."""
        return self.netG["A" if direction == "AtoB" else "B"](x)
