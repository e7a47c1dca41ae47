"""Idle device time a step between the markers of ``step.teacher_fwd``:
the frozen teacher's forward (input and teacher casts, its taps cast up)."""

from benchmark.metrics._phases import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "teacher_fwd", idle=True)
