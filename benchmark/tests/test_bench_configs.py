"""The benchmark's data: ``BENCHMARK.json`` keeps to its contract's shapes,
each cell's files exist and are found by name, and each configuration file
holds the published widths of the recipe it names."""

from __future__ import annotations

import importlib
import json
import os
import re
import shlex

import pytest

from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))

# recipe script of each configuration, and the flags its file must hold
RECIPES = {
    "h2z_2p6B": ("scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh",
                 ("teacher_ngf", "ndf", "channels_reduction_factor", "kernel_sizes",
                  "lambda_distill", "lambda_recon", "prune_cin_lb", "target_flops", "gan_mode",
                  "dataset_mode", "distill_G_loss_type", "norm_affine", "norm_affine_D")),
    "gaugan_5p6B": ("scripts/gaugan/cityscapes/train_inception_student_5p6B.sh",
                    ("input_nc", "contain_dontcare_label", "preprocess", "load_size",
                     "crop_size", "aspect_ratio", "teacher_ngf", "student_ngf",
                     "teacher_norm_G", "student_norm_G", "netD", "init_type",
                     "channels_reduction_factor", "kernel_sizes", "lambda_distill",
                     "prune_cin_lb", "target_flops", "distill_G_loss_type", "dataset_mode")),
}


def _flags(script: str):
    words = shlex.split(open(os.path.join(REPO, script)).read().replace("\\\n", " "),
                        comments=True)
    flags, key = {}, None
    for w in words:
        if w.startswith("--"):
            key = w[2:]
            flags[key] = True
        elif key is not None:
            flags[key] = [*flags[key], w] if isinstance(flags[key], list) else (
                w if flags[key] is True else [flags[key], w])
    return flags


def _same(value, flag):
    if flag is True:
        return value is True
    if isinstance(flag, list):
        return [float(v) for v in value] == [float(f) for f in flag]
    try:
        return float(value) == float(flag)
    except (TypeError, ValueError):
        return str(value) == flag


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_config_holds_the_published_widths(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    cfg = json.load(open(os.path.join(REPO, entry["file"])))
    script, keys = RECIPES[name]
    flags = _flags(script)
    assert entry["source"].endswith(script.split("/", 1)[1])
    for k in keys:
        assert k in flags and _same(cfg[k], flags[k]), (k, cfg.get(k), flags.get(k))
    assert cfg["reduced"] == entry["reduced"] == []


def test_traffic_holds_its_source():
    """The flagship traffic is bench.py's step; the GauGAN traffic and the
    horse2zebra float32 traffic are their recipes' batch and flags."""
    bench_py = open(os.path.join(REPO, "bench.py")).read()
    flagship = json.load(open(os.path.join(REPO, "benchmark", "traffic", "bf16_b128_fused.json")))
    assert re.search(r'BENCH_BATCH", "(\d+)"', bench_py).group(1) == str(flagship["batch"])
    assert re.search(r'BENCH_DTYPE", "(\w+)"', bench_py).group(1) == flagship["compute_dtype"]
    assert re.search(r"^SIZE = (\d+)", bench_py, re.M).group(1) == "256"
    gaugan = json.load(open(os.path.join(REPO, "benchmark", "traffic", "f32_b16.json")))
    flags = _flags(RECIPES["gaugan_5p6B"][0])
    assert int(flags["batch_size"]) == gaugan["batch"] and "compute_dtype" not in flags
    assert gaugan["compute_dtype"] == "float32"
    h2z = json.load(open(os.path.join(REPO, "benchmark", "traffic", "f32_b80.json")))
    script = RECIPES["h2z_2p6B"][0]
    flags = _flags(script)
    assert h2z["source"].startswith(script)
    assert int(flags["batch_size"]) == h2z["batch"] == 80
    assert "fused_norms" not in flags and h2z["fused_norms"] is False
    assert "compute_dtype" not in flags and h2z["compute_dtype"] == "float32"
    assert "packed_blocks" not in flags and h2z["packed_blocks"] is True


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_each_cell_is_found_by_name(cell):
    from benchmark.run import load_cell, metrics_of

    from benchmark import control

    spec = load_cell(BENCH, cell, REPO)
    family = importlib.import_module(f"benchmark.families.{spec['config']['family']}")
    assert family.setup and family.NETS and "unchanged" in family.FAULTS
    assert ("unchanged_d" in family.FAULTS) == ("D" in family.NETS)
    assert set(spec["limits"]) >= set(control.compared(family))
    from benchmark.run import reader

    for m in metrics_of(BENCH, "end_to_end", cell) + metrics_of(BENCH, "per_layer", cell):
        assert callable(reader(m["name"]).read)
    names = {m["name"] for m in metrics_of(BENCH, "end_to_end", cell)}
    assert "setup_s" in names and len(names) >= 2
    per_layer = metrics_of(BENCH, "per_layer", cell)
    assert per_layer and all(m["moves"] in names for m in per_layer)


def test_every_seed_shrinks_to_one_student():
    """The teachers' scales are a seeded ordering of a fixed set, so the
    shrink picks the same widths for every seed (the same work)."""
    import torch

    from benchmark.families.common import seeded_weights
    from benchmark.reference import inception_ka as iref
    from benchmark.reference import spade_ka as sref

    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", "h2z_2p6B.json")))
    arch = iref.teacher_arch(3, 3, cfg["teacher_ngf"], cfg["channels_reduction_factor"],
                             cfg["kernel_sizes"], cfg["n_blocks"])
    gc = json.load(open(os.path.join(REPO, "benchmark", "configs", "gaugan_5p6B.json")))
    garch = sref.teacher_arch(gc["input_nc"] + 2, gc["teacher_ngf"],
                              gc["channels_reduction_factor"], gc["kernel_sizes"],
                              gc["crop_size"], gc["aspect_ratio"])
    students, gstudents = [], []
    for seed in (1, 2 ** 31 + 5):
        p = seeded_weights(iref.generator_shapes(arch),
                           torch.Generator().manual_seed(seed), "cpu", True)
        students.append(iref.shrink(arch, p, cfg["target_flops"], 256, 256,
                                    cfg["prune_cin_lb"])[0])
        gp = seeded_weights(
            {k: v for k, v in sref.generator_shapes(garch).items() if v[1] == "scale"},
            torch.Generator().manual_seed(seed), "cpu", True)
        gstudents.append(sref.shrink(garch, gp, gc["target_flops"], gc["prune_cin_lb"]))
    assert students[0] == students[1]
    assert gstudents[0] == gstudents[1]
    assert sref.profile_macs(gstudents[0]) <= gc["target_flops"]


def test_fused_sites_are_the_programs():
    """The norm sites the yardstick counts for ``norm_kernel_roofline`` are,
    site for site, those the program sends through the fused kernel on
    the flagship's teacher and student at 256 px (``fused_norm_sites``),
    packed and unpacked."""
    import torch

    from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NormConfig
    from cat_tpu_torch.models.generator import fused_norm_sites

    from benchmark.families.common import seeded_weights
    from benchmark.families.inception_ka import _arch_of
    from benchmark.reference import inception_ka as iref
    from benchmark.yardstick import flops

    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", "h2z_2p6B.json")))
    teacher = InceptionGeneratorConfig.make(
        input_nc=3, output_nc=3, ngf=cfg["teacher_ngf"],
        channels_reduction_factor=cfg["channels_reduction_factor"],
        kernel_sizes=tuple(cfg["kernel_sizes"]), n_blocks=cfg["n_blocks"],
        norm=NormConfig(kind="instance", affine=True, track_running_stats=False))
    arch = iref.teacher_arch(3, 3, cfg["teacher_ngf"], cfg["channels_reduction_factor"],
                             cfg["kernel_sizes"], cfg["n_blocks"])
    assert _arch_of(teacher) == arch
    p = seeded_weights(iref.generator_shapes(arch), torch.Generator().manual_seed(3), "cpu", True)
    student = shrink_generator(teacher, p, cfg["target_flops"], 256, 256,
                               PruneBounds(cin_lb=cfg["prune_cin_lb"])).config
    counts = []
    for net in (teacher, student):
        for packed in (True, False):
            mine = flops.fused_norm_sites(_arch_of(net), 256, 256, packed)
            assert [(layer, c, h, act) for layer, c, h, w, act in mine] == fused_norm_sites(
                net, packed, 256)
            assert all(h == w for _, _, h, w, _ in mine)
            counts.append(len(mine))
    assert counts[0] == counts[2] == 50  # packed: 50 a flagship net


def test_reference_layouts_are_the_programs():
    """The parameter names and shapes the benchmark seeds for the reference
    are the program's state_dicts', so both sides read the same weights."""
    from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                 SPADEGeneratorConfig)
    from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator
    from cat_tpu_torch.models.vgg import VGG19Features

    from benchmark.families.spade_ka import _arch_of
    from benchmark.reference import spade_ka as sref

    cfg = SPADEGeneratorConfig.make(semantic_nc=37, ngf=8, channels_reduction_factor=6,
                                    kernel_sizes=(1, 3, 5), crop_size=128, aspect_ratio=2.0)
    for packed in (True, False):
        sd = SPADEGenerator(cfg, packed_blocks=packed).state_dict()
        shapes = sref.generator_shapes(_arch_of(cfg))
        assert {k: tuple(v.shape) for k, v in sd.items()} == {k: s for k, (s, _) in shapes.items()}
    d = MultiscaleDiscriminator(MultiscaleDiscriminatorConfig(input_nc=40)).state_dict()
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        k: s for k, (s, _) in sref.discriminator_shapes(40, 64, 4, 2).items()}
    assert {k: tuple(v.shape) for k, v in VGG19Features().state_dict().items()} == {
        k: s for k, (s, _) in sref.vgg_shapes().items()}


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_limits_lie_between_their_readings(cell):
    """Each limit lies above every program reading it was set from and
    below its upper reading, the recorded readings are those of the kept
    rows, every program row passes and every control and fault row fails."""
    from benchmark import compare, control
    from benchmark.run import load_cell

    family = importlib.import_module(
        f"benchmark.families.{load_cell(BENCH, cell, REPO)['config']['family']}")
    with open(os.path.join(REPO, "benchmark", "limits", f"{cell}.json")) as f:
        spec = json.load(f)
    rows = {}
    for mode in ("program", "control") + tuple(family.FAULTS):
        path = os.path.join(REPO, "benchmark", "limits", "readings", f"{cell}.{mode}.json")
        if os.path.isfile(path):
            with open(path) as f:
                rows[mode] = json.load(f)
    assert len({r["seed"] for r in rows["program"]}) >= 12
    assert {"control", *family.FAULTS} <= set(rows)
    got = control.readings(rows, family)
    limits = {k: v for k, v in spec["limits"].items() if k in control.compared(family)}
    assert set(limits) == set(control.compared(family))
    for k, lim in limits.items():
        assert spec["readings"]["lower"][k] == pytest.approx(got["lower"][k], rel=1e-3)
        assert got["lower"][k] < lim
        if k in got["upper"]:
            assert lim < got["upper"][k]
            assert spec["readings"]["upper"][k] == pytest.approx(got["upper"][k], rel=1e-3)
    assert all(compare.judge(r, limits) and r["student_arch"] == 0 for r in rows["program"])
    for mode in set(rows) - {"program"}:
        assert not any(compare.judge(r, limits) for r in rows[mode]), mode
