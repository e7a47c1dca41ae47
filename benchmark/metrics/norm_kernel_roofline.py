"""The fused instance-norm kernels' least time over their traced device
time: per step, the forward's x read and y written at each fused site and
the backward's x and g read and dx written at each site it runs
(``yardstick/roofline.py``), at HBM's rate.  Nothing to read where the cell
fuses no norm."""

from benchmark.metrics._groups import ms_per_step
from benchmark.yardstick.kernel_groups import NORM_BWD, NORM_FWD
from benchmark.yardstick.roofline import norm_backward_bound_s, norm_forward_bound_s


def read(ctx):
    w = ctx.work
    if not w.get("norm_fwd_values"):
        return None
    ms = ms_per_step(ctx, (NORM_FWD, NORM_BWD))
    if not ms:
        return None
    bound = sum(norm_forward_bound_s(v, w["dtype"]) for v in w["norm_fwd_values"])
    bound += sum(norm_backward_bound_s(v, w["dtype"]) for v in w["norm_bwd_values"])
    return 100.0 * bound * 1e3 / ms
