"""Images trained in the window (completed steps x batch) over the window's
whole time, from its start to the closing synchronise."""


def read(ctx):
    if not ctx.window_steps:
        return None
    return ctx.window_steps * ctx.work["images_per_step"] / ctx.window_s
