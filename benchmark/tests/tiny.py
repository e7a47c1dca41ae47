"""Tiny benchmark trees for the CPU tests: each family's configuration at
toy widths, under a float32 traffic of batch 2-4 (the family's ``tiny``),
in a directory laid out as a checkout is (``BENCHMARK.json``,
``benchmark/configs``, ``benchmark/traffic``, ``benchmark/limits``).

The families are the modules under ``benchmark/families/``, each with the
first configuration of ``BENCHMARK.json`` whose file names it."""

from __future__ import annotations

import glob
import importlib
import json
import os
from typing import Dict, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def limits(nets: Sequence[str]) -> Dict[str, float]:
    """The tiny cells' limits for a family that trains ``nets``: float32 on
    the CPU, the program and the reference agree to ~1e-5."""
    return {"loss_gap": 1e-4, **{f"grad_gap.{n}": 1e-4 for n in nets},
            **{f"change_gap.{n}": 2e-3 for n in nets}, "student_arch": 0}


def _families() -> Dict[str, str]:
    """Each family module with the first configuration that names it."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    modules = {os.path.basename(p)[:-3]
               for p in glob.glob(os.path.join(REPO, "benchmark", "families", "*.py"))}
    out = {}
    for entry in bench["configs"]:
        with open(os.path.join(REPO, entry["file"])) as f:
            family = json.load(f)["family"]
        if family in modules:
            out.setdefault(family, entry["name"])
    return out


FAMILIES = _families()


def make_root(root: str, family: str = "inception_ka") -> str:
    """Write a tree with one tiny cell of ``family`` under ``root``; returns
    the cell's name.  The cell takes the metrics and the control of the
    first cell of the family's configuration."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    source = FAMILIES[family]
    module = importlib.import_module(f"benchmark.families.{family}")
    entry = {c["name"]: c for c in bench["configs"]}[source]
    with open(os.path.join(REPO, entry["file"])) as f:
        cfg, traffic = module.tiny(json.load(f))
    cell = next(w["name"] for w in bench["workloads"] if w["config"] == source)
    with open(os.path.join(REPO, "benchmark", "limits", f"{cell}.json")) as f:
        control = json.load(f)["control"]
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, "benchmark", d), exist_ok=True)
    name = f"tiny.{family}"
    files = {
        "benchmark/configs/tiny.json": cfg,
        f"benchmark/traffic/{family}.json": traffic,
        f"benchmark/limits/{name}.json": {"limits": limits(module.NETS), "control": control},
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
