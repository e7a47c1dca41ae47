"""Readings that set a cell's correctness limits; no benchmark run runs this.

    python -m benchmark.control --workload <cell> --mode <mode> --seeds <n> [<n> ...] [--out <file>]

For each seed, in one process: the cell's set-up and first steps as a
benchmark run makes them (no window), the program's state freed, the plain
reference over the same steps, and the numbers ``compare.py`` compares.
``--mode``:

* ``program``: the program as the cell runs it (the lower readings);
* ``control``: the reference put in the program's place, computed in the
  precision that the cell's limits file names under ``"control"`` (the
  control's readings);
* ``unchanged``, ``unchanged_d``, ``half_batch``, ``altered``: the
  program with that fault planted by the family's ``fault`` (the faults'
  readings).

Prints one line a seed and, with ``--out``, writes them all as JSON.  The
rows a cell's limits were set from are kept as
``benchmark/limits/readings/<cell>.<mode>.json``; ``readings`` reduces them
to the lower and upper readings that ``limits/<cell>.json`` records.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import sys
import time
from typing import Dict, List

from benchmark import compare
from benchmark.run import load_cell, log
from benchmark.trace import import_stdlib_profile


COMPARED = ("loss_gap", "grad_gap.G", "grad_gap.D", "change_gap.G", "change_gap.D")
FAULTS = ("unchanged", "unchanged_d", "half_batch", "altered")


def readings(rows: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """The readings of each compared number from the rows of each mode: the
    program's largest (``lower``), the control's and each fault's smallest,
    and ``upper``, the least of the control's (where at least three times
    the lower) and the faults' (where at least ten times the lower; a state
    left unchanged, three times)."""
    out = {"lower": {k: max(r[k] for r in rows["program"]) for k in COMPARED}}
    upper = {}
    for mode in ("control",) + FAULTS:
        if mode not in rows:
            continue
        out[mode] = {k: min(r[k] for r in rows[mode]) for k in COMPARED}
        factor = 3.0 if mode in ("control", "unchanged", "unchanged_d") else 10.0
        for k in COMPARED:
            if out[mode][k] >= factor * out["lower"][k]:
                upper[k] = min(upper.get(k, math.inf), out[mode][k])
    out["upper"] = upper
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=".")
    p.add_argument("--traffic", default="{}",
                   help="JSON object of traffic keys to change (a witness run)")
    p.add_argument("--exact", action="store_true",
                   help="run the program's float32 convolutions without TF32 (a witness run)")
    args = p.parse_args(argv)
    import_stdlib_profile()
    import torch

    with open(f"{args.root}/BENCHMARK.json") as f:
        spec = load_cell(json.load(f), args.workload, args.root)
    with open(f"{args.root}/benchmark/limits/{args.workload}.json") as f:
        control = json.load(f).get("control", {})
    family = importlib.import_module(f"benchmark.families.{spec['config']['family']}")
    device = torch.device(args.device)
    if args.exact:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for seed in args.seeds:
        t0 = time.monotonic()
        planted = (family.fault(args.mode) if args.mode not in ("program", "control")
                   else contextlib.nullcontext())
        with planted:
            cell = family.setup(spec["config"], {**spec["traffic"], **json.loads(args.traffic)},
                                seed, device,
                                program=args.mode != "control")
        cell.free()
        reference = cell.reference()
        if args.mode == "control":
            cell.record = cell.reference(control)
        numbers = compare.training_gaps(cell.record, reference, family.AFTER_UPDATE)
        numbers["student_arch"] = reference.get("student_arch", 0.0)
        worst = {"grad": compare.worst_leaves(cell.record["first_grad"], reference["first_grad"],
                                              list(reference["first_grad"])),
                 "change": compare.worst_leaves(cell.record["change"], reference["change"],
                                                compare.moving_leaves(reference["first_grad"]))}
        row = {"seed": seed, "mode": args.mode, **numbers, "worst": worst,
               "seconds": time.monotonic() - t0,
               "losses_program": cell.record["losses"], "losses_reference":
               reference["losses"]}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if not k.startswith("losses")}),
              flush=True)
        del cell, reference
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for k in COMPARED + ("loss_gap_all", "grad_worst", "change_worst"):
        vals = [r.get(k, math.inf) for r in rows]
        log(f"{args.mode} {k}: min {min(vals):.4g} max {max(vals):.4g} over {len(vals)} seeds")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
