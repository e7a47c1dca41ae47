"""Device time a step of the traced window's kernels in some groups."""

from benchmark.yardstick.kernel_groups import group_of


def ms_per_step(ctx, groups):
    tl = ctx.timeline
    if tl is None or not tl.steps:
        return None
    ns = [e - s for n, s, e in tl.kernels() if group_of(n) in groups]
    if not ns:
        return None
    return sum(ns) / 1e6 / tl.steps
