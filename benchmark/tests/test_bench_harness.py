"""The harness end to end on the CPU at a tiny size, for each family: a
run of the tiny cell is correct and reads its metrics by name, and comes
out not correct under the control and under each fault planted in the
program's step."""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import compare, run
from benchmark.tests.tiny import FAMILIES, REPO, limits, make_root

# each family with each fault it declares
FAULTS = [(f, fault) for f in sorted(FAMILIES)
          for fault in importlib.import_module(f"benchmark.families.{f}").FAULTS]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def tree(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    return d, make_root(d, request.param), importlib.import_module(
        f"benchmark.families.{request.param}")


def _run(tree, trace=0, seed=3000000019):
    root, cell, _ = tree
    return run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                    "--trace", str(trace)], device_override="cpu", root=root)


def _load(tree, *parts):
    with open(os.path.join(tree[0], *parts)) as f:
        return json.load(f)


def test_tiny_cell_runs_and_is_correct(tree):
    r = _run(tree)
    assert r["correct"], r["checks"]
    assert {k.split(".")[0] for k in r["metrics"]} == {"images_per_s", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["student_arch"]["value"] == 0.0


def test_tiny_cell_traced_reads_per_layer_metrics(tree):
    r = _run(tree, trace=1, seed=17)
    assert r["correct"], r["checks"]
    # on the CPU no device operation runs: only the host-clock metrics read
    assert any(k.startswith("mfu_pct") for k in r["metrics"])
    assert not any(k.startswith("gram_roofline") for k in r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r)


def test_same_seed_same_record(tree):
    _, cell, family = tree
    spec, traffic = _load(tree, "benchmark", "configs", "tiny.json"), None
    traffic = _load(tree, "benchmark", "traffic", f"{cell.split('.')[1]}.json")
    a = family.setup(spec, traffic, 5, torch.device("cpu"))
    b = family.setup(spec, traffic, 5, torch.device("cpu"))
    assert a.record == b.record
    assert a.program_student == b.program_student


@pytest.mark.parametrize("tree,fault", FAULTS, indirect=["tree"])
def test_each_fault_is_not_correct(tree, fault):
    with tree[2].fault(fault):
        r = _run(tree)
    assert not r["correct"], (fault, r["checks"])


def test_control_is_not_correct(tree):
    """The reference in the control's precision (bf16 for a float32 cell,
    fp8 for a bf16 one) in the program's place fails the comparison."""
    _, cell, family = tree
    spec = _load(tree, "benchmark", "configs", "tiny.json")
    traffic = _load(tree, "benchmark", "traffic", f"{cell.split('.')[1]}.json")
    control = _load(tree, "benchmark", "limits", f"{cell}.json")["control"]
    c = family.setup(spec, traffic, 11, torch.device("cpu"), program=False)
    numbers = compare.training_gaps(c.reference(control), c.reference(), family.AFTER_UPDATE)
    assert not compare.judge(numbers, {k: v for k, v in limits(family.NETS).items()
                                       if k != "student_arch"})


def test_no_card_no_result(tree):
    """Without a card the run refuses (exit 2) and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", tree[1],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tree[0],
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"},
                         capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_bare_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files gives
    no result: the program is not there."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "h2z_2p6B.bf16_b128_fused", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
