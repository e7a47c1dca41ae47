"""The traced window: ``torch.profiler`` over some steps, reduced to the
device's timeline.

The harness marks the window with a host span (``WINDOW``) and each step
with ``STEP``.  From the profiler's raw events it keeps the device's
operations (kernels, copies, sets) and the host's spans and ops, and works
out what the per-layer metrics read: the union of device intervals inside
the window (busy time), the gaps between them, and what the host was in
while the device idled.
"""

from __future__ import annotations

import bisect
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.traced_window"
STEP = "bench.step"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
MAX_ATTRIBUTED_GAPS = 1000  # the longest gaps; the rest are summed as one
MAX_SCAN = 2000  # host events looked back over for a gap's cover


def import_stdlib_profile() -> None:
    """Import the standard library's ``profile`` (TorchDynamo reaches it
    through ``cProfile`` when ``torch.profiler`` loads).  A ``profile.py``
    on ``sys.path``, as this repository's root holds, would shadow it."""
    if "profile" in sys.modules:
        return
    stdlib = os.path.dirname(os.__file__)
    saved = sys.path[:]
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") == stdlib
                   or not os.path.isfile(os.path.join(p or ".", "profile.py"))]
    try:
        import cProfile  # noqa: F401
        import profile  # noqa: F401
    finally:
        sys.path[:] = saved


@dataclass
class Timeline:
    """One traced window, times in ns on the profiler's clock."""

    start: int
    end: int
    steps: int
    device: List[Tuple[str, int, int, str]]  # (name, start, end, activity)
    host: List[Tuple[str, int, int]]  # (name, start, end), sorted by start

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [(n, s, e) for n, s, e, a in self.device if a == "kernel"]

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's operation intervals, clipped to the window."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e, _ in self.device
                       if e > self.start and s < self.end)
        merged: List[Tuple[int, int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.start
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took the most time, summed by name."""
        tot: Dict[str, int] = {}
        for n, s, e, _ in self.device:
            tot[n] = tot.get(n, 0) + (e - s)
        return [[n[:200], v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time summed by what the host was in at each gap's midpoint:
        the innermost host op or span that covers it."""
        starts = [s for _, s, _ in self.host]
        tot: Dict[str, int] = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        for i, (gs, ge) in enumerate(gaps):
            if i >= MAX_ATTRIBUTED_GAPS:
                name = "shorter gaps"
            else:
                mid = (gs + ge) // 2
                name = "host outside any op"
                j = bisect.bisect_right(starts, mid) - 1
                for k in range(j, max(j - MAX_SCAN, -1), -1):
                    n, s, e = self.host[k]
                    if e >= mid:
                        name = n
                        break
            tot[name] = tot.get(name, 0) + (ge - gs)
        return [[n[:200], v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _activity(e, annotations) -> str:
    """An event's Kineto activity: ``activity_type()`` where this torch has
    it, else told from its device, its flags and its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else name in annotations
    if "CUDA" not in str(e.device_type()):
        return "user_annotation" if user else "cpu_op"
    if user or name in annotations:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def timeline(prof, steps: int) -> Optional[Timeline]:
    """The traced window's timeline from a finished ``torch.profiler``
    profile, or None when it holds no window span."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    start = end = None
    for e in events:
        name, act = e.name(), _activity(e, (WINDOW, STEP))
        s = e.start_ns()
        t = s + e.duration_ns()
        if act in DEVICE_ACTIVITIES:
            device.append((name, s, t, act))
        elif act in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            if name == WINDOW:
                start, end = s, t
            host.append((name, s, t))
    if start is None:
        return None
    host.sort(key=lambda h: h[1])
    return Timeline(start, end, steps, device, host)
