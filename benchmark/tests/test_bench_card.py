"""Each cell at its own size on the card: a short run is correct and
reports its metrics.  Marked ``cuda``; skips without a card.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import REPO

BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells drive the port's CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_cell_runs_correct_on_the_card(card, cell):
    r = run.run(["--workload", cell, "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                root=REPO)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert any(k.startswith("images_per_s") and v["value"] > 0 for k, v in r["metrics"].items())
