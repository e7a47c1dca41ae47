"""Busy device time a step between the markers of ``step.d_loss_bwd``:
D's loss and its gradient (D's forwards, any penalty, ``autograd.grad``)."""

from benchmark.metrics._phases import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "d_loss_bwd")
