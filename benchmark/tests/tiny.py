"""Tiny benchmark trees for the CPU tests: each family's configuration at
toy widths, under a float32 traffic of batch 2-4, in a directory laid out
as a checkout is (``BENCHMARK.json``, ``benchmark/configs``,
``benchmark/traffic``, ``benchmark/limits``)."""

from __future__ import annotations

import json
import os

from benchmark.reference import inception_ka, spade_ka
from benchmark.yardstick import flops

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# float32 on the CPU: the program and the reference agree to ~1e-5
LIMITS = {"loss_gap": 1e-4, "grad_gap.G": 1e-4, "grad_gap.D": 1e-4, "change_gap.G": 2e-3,
          "change_gap.D": 2e-3, "student_arch": 0}
FAMILIES = {"inception_ka": "h2z_2p6B", "spade_ka": "gaugan_5p6B"}


def _tiny(family: str, cfg: dict) -> tuple:
    """The toy configuration and traffic of a family."""
    if family == "inception_ka":
        teacher = inception_ka.teacher_arch(3, 3, 8, 6, [1, 3, 5], 3)
        cfg.update(teacher_ngf=8, ndf=8, n_blocks=3, prune_cin_lb=2, crop_size=32,
                   target_flops=flops.profile_macs(teacher, 32, 32) // 2)
        return cfg, {"batch": 4, "compute_dtype": "float32", "fused_norms": True,
                     "packed_blocks": True, "bank": 4, "warmup_steps": 1, "print_freq": 2,
                     "trace_steps": 2}
    teacher = spade_ka.teacher_arch(37, 8, 6, [1, 3, 5], 128, 2.0)
    cfg.update(teacher_ngf=8, ndf=8, crop_size=128, prune_cin_lb=1,
               target_flops=spade_ka.profile_macs(teacher) // 2)
    return cfg, {"batch": 2, "compute_dtype": "float32", "vgg_compute_dtype": "float32",
                 "packed_blocks": True, "regions": 6, "bank": 4, "warmup_steps": 1,
                 "print_freq": 2, "trace_steps": 2}


def make_root(root: str, family: str = "inception_ka") -> str:
    """Write a tree with one tiny cell of ``family`` under ``root``; returns
    the cell's name."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    source = FAMILIES[family]
    entry = {c["name"]: c for c in bench["configs"]}[source]
    with open(os.path.join(REPO, entry["file"])) as f:
        cfg, traffic = _tiny(family, json.load(f))
    cell = {w["config"]: w["name"] for w in bench["workloads"]}[source]
    with open(os.path.join(REPO, "benchmark", "limits", f"{cell}.json")) as f:
        control = json.load(f)["control"]
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "benchmark", d), exist_ok=True)
    name = f"tiny.{family}"
    files = {
        "benchmark/configs/tiny.json": cfg,
        f"benchmark/traffic/{family}.json": traffic,
        f"benchmark/limits/{name}.json": {"limits": LIMITS, "control": control},
    }
    bench["configs"] = [{**entry, "name": "tiny", "file": "benchmark/configs/tiny.json"}]
    bench["workloads"] = [{"name": name, "config": "tiny", "traffic": family, "chips": 1,
                           "why": "a CPU test's cell"}]
    for section in ("end_to_end", "per_layer"):  # the source cell's metrics
        bench[section] = [m for m in bench[section] if cell in m.get("workloads", [cell])]
        for m in bench[section]:
            m.pop("workloads", None)
    files["BENCHMARK.json"] = bench
    for path, obj in files.items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)
    return name
