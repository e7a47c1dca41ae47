"""Device time a step of one phase of the program's step, read between the
phase's markers.

The program marks each phase of its step with a host span ``step.<phase>``
and, on the card, with a marker kernel (ATen's ``spin_kernel``, run for
zero cycles) launched on the step's stream at the span's entry and at its
exit.  The stream runs the phase's work between its two markers however
far the device runs behind the host, so the k-th span of the window, in
order of start, runs on the device from the end of the 2k-th marker to the
start of the (2k+1)-th.  Busy is the union of the other device operations
clipped to that interval; idle is the rest of it.  A window whose markers
do not pair with its spans (a program without spans, or a trace that lost
a marker) reads None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

MARKER = "spin_kernel"
PREFIX = "step."


def _merged(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _covered(merged: List[Tuple[int, int]], starts: List[int], lo: int, hi: int) -> int:
    """The length of [lo, hi) that the disjoint sorted ``merged`` covers."""
    total = 0
    k = max(bisect.bisect_right(starts, lo) - 1, 0)
    while k < len(merged) and merged[k][0] < hi:
        total += max(0, min(merged[k][1], hi) - max(merged[k][0], lo))
        k += 1
    return total


def phases(tl) -> Optional[List[Tuple[str, int, int]]]:
    """Each ``step.*`` span of the window as (phase, busy ns, idle ns) on
    the device, in order; None where the markers do not pair with them."""
    spans = sorted((s, n[len(PREFIX):]) for n, s, e in tl.host
                   if n.startswith(PREFIX) and s >= tl.start and e <= tl.end)
    # the markers are not clipped to the window: the device's times, carried
    # onto the host's clock, can end the last one just past the window's end
    markers = sorted((s, e) for n, s, e in tl.kernels() if MARKER in n)
    if not spans or len(markers) != 2 * len(spans):
        return None
    busy = _merged((s, e) for n, s, e, _ in tl.device if MARKER not in n)
    starts = [s for s, _ in busy]
    out = []
    for k, (_, phase) in enumerate(spans):
        lo, hi = markers[2 * k][1], markers[2 * k + 1][0]
        b = _covered(busy, starts, lo, hi) if hi > lo else 0
        out.append((phase, b, max(hi - lo, 0) - b))
    return out


def ms_per_step(ctx, phase: str, idle: bool = False) -> Optional[float]:
    """Busy (or ``idle``) device time a step of ``phase``'s spans, in ms."""
    tl = ctx.timeline
    if tl is None or not tl.steps:
        return None
    found = phases(tl)
    if found is None:
        return None
    ns = [i if idle else b for p, b, i in found if p == phase]
    if not ns:
        return None
    return sum(ns) / 1e6 / tl.steps
