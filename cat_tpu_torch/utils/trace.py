"""Phase spans of a training step, for ``torch.profiler``.

``span(name, device)`` marks one phase of a step (``step.teacher_fwd``,
``step.adam``, ...).  With no profiler recording it reads one flag and
returns a shared no-op context: no ``record_function``, no dispatcher call,
no CUDA call.  Under a recording profiler it is a ``record_function`` span
on the host and, on a CUDA device, it also launches a marker kernel
(``MARKER``: ATen's ``spin_kernel`` for zero cycles) on the current stream
at its entry and at its exit.  The stream runs the phase's kernels between
its two markers however far the device runs behind the host, so the
markers bound the phase on the device's own clock; autograd's device
thread runs a backward on the forward's stream, so they bracket it too.

``region(name)`` marks a part of a phase (a model's attention or norm
blocks) on the host alone: a bare ``record_function`` under a recording
profiler, so the trace's idle gaps can name it, and no marker kernel,
whose count the phase metrics pair with the ``step.*`` spans.
"""

from __future__ import annotations

import contextlib

import torch

MARKER = "spin_kernel"  # the marker kernel's name in a device trace
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("_record", "_cuda")

    def __init__(self, name: str, device):
        self._record = torch.autograd.profiler.record_function(name)
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        self._record.__enter__()
        if self._cuda:
            torch.cuda._sleep(0)

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda._sleep(0)
        return self._record.__exit__(*exc)


def span(name: str, device=None):
    """A span named ``name`` over a phase of work on ``device``: a no-op
    unless a profiler is recording."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def region(name: str):
    """A host-only span named ``name``: a no-op unless a profiler is
    recording, and never a marker kernel."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.autograd.profiler.record_function(name)
