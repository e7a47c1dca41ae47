"""Idle device time a step between the markers of ``step.student_fwd``:
the student's forward, graph kept."""

from benchmark.metrics._phases import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "student_fwd", idle=True)
