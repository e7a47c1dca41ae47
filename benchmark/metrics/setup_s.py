"""Set-up: process start to the first timed step (imports, seeded weights,
the shrink, the bank, the program's state, its first steps; the first run
in a checkout also builds the CUDA kernels)."""


def read(ctx):
    return ctx.setup_s
