"""The KA Gram kernels' least time over their traced device time: per step,
each Gram of a (B, F) tap, the larger of X read and G written at HBM's rate
and its lower triangle's B(B+1)·F operations at the operand dtype's peak
(``yardstick/roofline.py``)."""

from benchmark.metrics._groups import ms_per_step
from benchmark.yardstick.kernel_groups import GRAM
from benchmark.yardstick.roofline import gram_bound_s


def read(ctx):
    w = ctx.work
    if not w.get("grams"):
        return None
    ms = ms_per_step(ctx, (GRAM,))
    if not ms:
        return None
    bound = sum(gram_bound_s(b, f, w["dtype"]) for b, f in w["grams"])
    return 100.0 * bound * 1e3 / ms
