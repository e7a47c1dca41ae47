"""The phase readers (``benchmark/metrics/_phases.py``) on timelines built by
hand: busy and idle time a step between each span's markers, a kernel
straddling a marker clipped, work between two phases left out, and None
where the markers do not pair with the spans or no span exists."""

from __future__ import annotations

import pytest

from benchmark.metrics import _phases
from benchmark.run import Context, reader
from benchmark.trace import STEP, Timeline
from benchmark.yardstick.kernel_groups import OTHER, group_of

MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
US = 1000  # ns


def _k(name, s, e, act="kernel"):
    return (name, s * US, e * US, act)


def _timeline(drop_marker=False, spans=True):
    """Two steps' worth of three spans (times in µs): teacher, adam, teacher.

    teacher: markers at 100-102 and 210-212; a kernel from 95 (before the
      first marker ends) to 150, a kernel 160-200 and a copy 170-180 under
      it: busy 48 + 40, idle 20;
    between the phases a kernel 220-240, in no phase;
    adam: markers 300-302 and 402-404, one kernel 302-402: busy 100, idle 0;
    teacher again: markers 500-502 and 540-542, a kernel 510-530: busy 20,
      idle 18.
    """
    device = [_k(MARK, 100, 102), _k("conv_fwd", 95, 150), _k("elementwise_kernel", 160, 200),
              _k("Memcpy DtoD", 170, 180, "gpu_memcpy"), _k(MARK, 210, 212),
              _k("reduce_kernel", 220, 240),
              _k(MARK, 300, 302), _k("multi_tensor_apply_kernel", 302, 402), _k(MARK, 402, 404),
              _k(MARK, 500, 502), _k("gemm", 510, 530), _k(MARK, 540, 542)]
    if drop_marker:
        device = [d for d in device if not (d[0] == MARK and d[1] == 402 * US)]
    host = [(STEP, 0, 99 * US)]
    if spans:
        host += [("step.teacher_fwd", 1 * US, 50 * US), ("aten::conv2d", 2 * US, 3 * US),
                 ("step.adam", 60 * US, 90 * US), ("step.teacher_fwd", 95 * US, 99 * US),
                 ("step.adam", -50 * US, -40 * US)]  # before the window: not read
    return Timeline(0, 1000 * US, 2, device, sorted(host, key=lambda h: h[1]))


def _read(name, tl):
    return reader(name).read(Context(timeline=tl))


def test_busy_and_idle_per_phase():
    tl = _timeline()
    assert _phases.phases(tl) == [("teacher_fwd", 88 * US, 20 * US), ("adam", 100 * US, 0),
                                  ("teacher_fwd", 20 * US, 18 * US)]
    # summed over the spans of a name, over the window's two steps, in ms
    assert _read("teacher_fwd_ms_per_step", tl) == pytest.approx(0.054)
    assert _read("teacher_fwd_idle_ms_per_step.spade", tl) == pytest.approx(0.019)
    assert _read("adam_ms_per_step", tl) == pytest.approx(0.05)
    # a phase with no span in the window reads nothing
    assert _read("student_fwd_ms_per_step", tl) is None
    assert _read("d_loss_bwd_idle_ms_per_step", tl) is None


def test_marker_past_the_window_end_still_reads():
    """The device's times, carried onto the host's clock, can end the last
    marker just past the window's host end: it still closes its span."""
    tl = _timeline()
    tl.end = 541 * US
    assert _phases.phases(tl)[-1] == ("teacher_fwd", 20 * US, 18 * US)
    assert _read("teacher_fwd_ms_per_step", tl) == pytest.approx(0.054)


def test_missing_marker_reads_none():
    tl = _timeline(drop_marker=True)
    assert _phases.phases(tl) is None
    for name in ("teacher_fwd_ms_per_step", "adam_ms_per_step", "teacher_fwd_idle_ms_per_step"):
        assert _read(name, tl) is None


def test_no_span_reads_none():
    tl = _timeline(spans=False)
    assert _phases.phases(tl) is None
    assert _read("teacher_fwd_ms_per_step", tl) is None
    assert reader("adam_ms_per_step").read(Context()) is None


@pytest.mark.parametrize("name", ["teacher_fwd", "student_fwd", "d_loss_bwd", "g_loss_bwd"])
def test_every_phase_has_a_busy_and_an_idle_reader(name):
    tl = Timeline(0, 10 * US, 1, [_k(MARK, 1, 2), _k("k", 2, 5), _k(MARK, 8, 9)],
                  [(f"step.{name}", 0, 1 * US)])
    assert _read(f"{name}_ms_per_step", tl) == pytest.approx(0.003)
    assert _read(f"{name}_idle_ms_per_step", tl) == pytest.approx(0.003)


def test_marker_is_the_programs_and_moves_no_kernel_group():
    from cat_tpu_torch.utils import trace

    assert trace.MARKER == _phases.MARKER
    assert group_of(MARK) == OTHER
