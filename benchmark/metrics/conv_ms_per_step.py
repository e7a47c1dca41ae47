"""Device time a step in the "convolution / matmul" kernel group."""

from benchmark.metrics._groups import ms_per_step
from benchmark.yardstick.kernel_groups import CONV


def read(ctx):
    return ms_per_step(ctx, (CONV,))
