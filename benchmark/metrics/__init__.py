"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

Each module defines ``read(ctx) -> float | None``.  ``ctx`` is the run's
``benchmark.run.Context``: the set-up time, the measured window (steps,
seconds, peak memory), the cell's work (``work()`` of its family: the
step's operations, the fused norm sites, the Gram operands), the precision
the convolutions ran in, and with ``--trace 1`` the traced window's
``Timeline``.  A reader that finds nothing to read returns None, and the
harness leaves its metric out of the result.
"""
