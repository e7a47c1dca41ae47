"""Run one benchmark cell once and print its result as the last line of
standard output.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell names
a configuration (its file under ``benchmark/configs/``, whose ``family``
names the module under ``benchmark/families/`` that drives the program)
and a traffic mix (``benchmark/traffic/<traffic>.json``); its limits are
``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<quantity>.py``, the quantity being its name up to the
first dot.  Nothing of one cell is written here.

A run: set-up (seeded weights and batches, the program's state, its first
steps, recorded for the check), then the measured window: the step back to
back for ``--seconds``, ended by one synchronise.  With ``--trace 1`` a
traced window of the traffic's ``trace_steps`` steps follows, and the
per-layer metrics are read from it.  Then the program's state is freed, the
plain reference replays the first steps, and ``compare.py`` decides
``correct``.  Without a CUDA card (or with fewer than the cell asks for),
or with JAX or the JAX package loaded, the run prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T0 = time.monotonic()  # before the heavy imports: set-up counts them

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from benchmark import compare  # noqa: E402
from benchmark.trace import STEP, WINDOW, Timeline, import_stdlib_profile, timeline  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cat_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


@dataclass
class Context:
    """What the metric readers read (``benchmark/metrics/__init__.py``)."""

    setup_s: float = 0.0
    window_steps: int = 0
    window_s: float = 0.0
    window_peak_bytes: int = 0
    precision: str = ""
    work: Dict = field(default_factory=dict)
    timeline: Optional[Timeline] = None


def load_cell(bench: Dict, name: str, root: str) -> Dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise NoResult(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "benchmark", "limits", f"{name}.json")) as f:
        limits = json.load(f)["limits"]
    return {"cell": cell, "config": config, "traffic": traffic, "limits": limits}


def metrics_of(bench: Dict, section: str, cell: str) -> List[Dict]:
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<quantity>.py``,
    the quantity being the name up to its first dot (``mfu_pct.spade`` is
    ``mfu_pct`` split off for the cells that report ``images_per_s.spade``)."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def read_metrics(specs: List[Dict], ctx: Context) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _finite(v: float):
    """A number JSON can carry: a non-finite one as its name."""
    return v if math.isfinite(v) else str(v)


def log(msg: str) -> None:
    print(f"[bench +{time.monotonic() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(argv: List[str], device_override: Optional[str] = None, root: str = ".") -> Dict:
    """One run of a cell; returns the result object.  ``device_override``
    ("cpu", for the tests) skips the look for a card and runs there."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import_stdlib_profile()
    import torch

    bench_path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(bench_path):
        raise NoResult(f"{bench_path} not found: run from the root of a checkout")
    with open(bench_path) as f:
        bench = json.load(f)
    spec = load_cell(bench, args.workload, root)
    chips = spec["cell"]["chips"]
    if device_override is None:
        if not torch.cuda.is_available():
            raise NoResult("CUDA is not available: this benchmark measures an NVIDIA GPU")
        if torch.cuda.device_count() < chips:
            raise NoResult(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device_override)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    config, traffic = spec["config"], spec["traffic"]
    family = importlib.import_module(f"benchmark.families.{config['family']}")
    ctx = Context(precision=traffic["compute_dtype"])
    if ctx.precision == "float32" and on_card and torch.backends.cudnn.allow_tf32:
        ctx.precision = "tf32"  # PyTorch's default: cuDNN's float32 convolutions in TF32
    log(f"set-up of {args.workload}, seed {args.seed}, on {device}")
    cell = family.setup(config, traffic, args.seed, device)
    k = 0
    for _ in range(traffic.get("warmup_steps", 0)):
        cell.step(k)
        k += 1
    sync()
    ctx.setup_s = time.monotonic() - T0
    ctx.work = cell.work()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    log(f"set-up done in {ctx.setup_s:.2f} s; window of {args.seconds} s")

    # --- the measured window: steps back to back, one synchronise at its end ---
    print_freq = traffic.get("print_freq", 100)
    readings: List[float] = []
    t0 = time.perf_counter()
    n = 0
    metrics = {}
    while time.perf_counter() - t0 < args.seconds:
        metrics = cell.step(k)
        k += 1
        n += 1
        if n % print_freq == 0:  # the verb brings its losses to the host at this cadence
            readings += [float(v) for v in metrics.values()]
    sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.window_steps = n
    readings += [float(v) for v in metrics.values()]
    failed = sum(1 for v in readings if not math.isfinite(v))
    if on_card:
        ctx.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        peak = max(peak, ctx.window_peak_bytes)
    log(f"window: {n} steps in {ctx.window_s:.3f} s")

    result_metrics: Dict[str, Dict] = {}
    dev_info: Dict = {"platform": "gpu" if on_card else device.type,
                      "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                      "count": chips if on_card else 0}
    breakdown = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        steps = traffic["trace_steps"]
        sync()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(steps):
                    with record_function(STEP):
                        cell.step(k)
                    k += 1
                sync()
        ctx.timeline = timeline(prof, steps)
        del prof
        if on_card:
            peak = max(peak, torch.cuda.max_memory_allocated(device))
        result_metrics = read_metrics(metrics_of(bench, "per_layer", args.workload), ctx)
        tl = ctx.timeline
        if tl is not None:
            dev_info["busy_s"] = tl.busy_s()
            dev_info["window_s"] = tl.window_s
            breakdown = {"device_ops": tl.device_ops(), "idle_gaps": tl.idle_gaps()}
        log(f"traced window: {steps} steps")
    else:
        result_metrics = read_metrics(metrics_of(bench, "end_to_end", args.workload), ctx)
    dev_info["memory_peak_bytes"] = int(peak)
    if on_card:
        dev_info["power"] = _power_limit()
        dev_info["precision"] = ctx.precision

    # --- the check, once the program's state is freed ---
    cell.free()
    t_ref = time.monotonic()
    reference = cell.reference()
    numbers = compare.training_gaps(cell.record, reference, family.AFTER_UPDATE)
    numbers["student_arch"] = reference.get("student_arch", 0.0)
    limits = spec["limits"]
    correct = compare.judge(numbers, limits)
    log(f"reference: {time.monotonic() - t_ref:.2f} s")

    found = forbidden_modules()
    if found:
        raise NoResult(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")

    result = {"correct": correct, "attempted": n, "failed": failed, "metrics": result_metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(numbers.get(k, math.inf)), "limit": v}
                        for k, v in limits.items()}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    try:
        result = run(sys.argv[1:] if argv is None else argv)
    except NoResult as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
