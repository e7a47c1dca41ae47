"""Device time a step in the "elementwise / copy / cast" and "reduction"
kernel groups: the plain norms' float32 passes, the casts, the losses."""

from benchmark.metrics._groups import ms_per_step
from benchmark.yardstick.kernel_groups import ELEMENTWISE, REDUCTION


def read(ctx):
    return ms_per_step(ctx, (ELEMENTWISE, REDUCTION))
