"""The step's share of the card's dense peak: the algorithm's operations in
the measured window (``yardstick/flops.py``) over the window's time, against
the peak of the precision the convolutions ran in (``yardstick/roofline.py``)."""

from benchmark.yardstick.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.window_steps or ctx.precision not in PEAK_FLOPS:
        return None
    rate = ctx.window_steps * ctx.work["flops_per_step"] / ctx.window_s
    return 100.0 * rate / PEAK_FLOPS[ctx.precision]
