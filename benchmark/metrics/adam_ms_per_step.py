"""Busy device time a step between the markers of ``step.adam``: both
optimiser steps (their gradients averaged over the ranks) and the EMA of
the student's weights."""

from benchmark.metrics._phases import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "adam")
