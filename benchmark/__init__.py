"""The benchmark of ``cat_tpu_torch`` on one NVIDIA GPU: ``python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout (``run.py``).  Cells, configurations, traffic,
limits and metrics are named in ``BENCHMARK.json`` and found here by name;
``control.py`` takes the readings the correctness limits are set from."""
