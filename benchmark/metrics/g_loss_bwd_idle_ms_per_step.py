"""Idle device time a step between the markers of ``step.g_loss_bwd``:
G's loss and its gradient (D on the fake, recon or feature and VGG terms, KA,
``autograd.grad``, a remat recompute included)."""

from benchmark.metrics._phases import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "g_loss_bwd", idle=True)
