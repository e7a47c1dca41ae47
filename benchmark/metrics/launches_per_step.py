"""CUDA kernels in the traced window over its steps."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.steps or not tl.kernels():
        return None
    return len(tl.kernels()) / tl.steps
