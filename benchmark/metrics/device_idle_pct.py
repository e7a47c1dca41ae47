"""The share of the traced window in which no operation runs on the card:
one minus the union of its operations' intervals over the window.  The
profiler's own host work (recording every CPU op) slows the launching
thread inside that window, so where the host paces the step this reads
above an untraced window's idle share."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
