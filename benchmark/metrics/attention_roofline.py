"""The attention kernels' least time over their traced device time: per
step, each attention site's forward in both nets and its backward in the
student (``work()["attention_fwd"]``, ``["attention_bwd"]``: batch x heads,
tokens, head width), the larger of its operations at the dtype's peak and
its bytes at HBM's rate (``yardstick/adm.py::attention_bound_s``)."""

from benchmark.metrics.attention_ms_per_step import attention_ns
from benchmark.yardstick.adm import attention_bound_s


def read(ctx):
    w, tl = ctx.work, ctx.timeline
    if not w.get("attention_fwd") or tl is None or not tl.steps:
        return None
    ns = attention_ns(tl)
    if not ns:
        return None
    bound = sum(attention_bound_s(bh, t, d, w["dtype"], False) for bh, t, d in w["attention_fwd"])
    bound += sum(attention_bound_s(bh, t, d, w["dtype"], True) for bh, t, d in w["attention_bwd"])
    return 100.0 * bound * 1e9 * tl.steps / ns
