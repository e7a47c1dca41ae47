"""Device time a step of ATen's GroupNorm kernels, forward and backward
(the statistics, the fused affine parameters, the normalising pass, the
backward's gradients), found by name (``NAMES``: substrings of the
lower-cased kernel name); the float32 casts around them are not counted.
Nothing to read where the cell runs no GroupNorm."""

NAMES = ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
         "computeinternalgradients", "computebackwardfusedparams", "gammabetabackward")


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.steps:
        return None
    ns = sum(e - s for n, s, e in tl.kernels() if any(k in n.lower() for k in NAMES))
    return ns / 1e6 / tl.steps if ns else None
