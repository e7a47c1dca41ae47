"""A family whose program trains one network goes into the benchmark with
new files and new ``BENCHMARK.json`` entries alone: its tiny cell runs
``correct`` on the CPU, its limits hold no D key, ``control`` reduces its
rows on its own numbers, and each fault it declares comes out not correct.

The family is planted for these tests only, under
``benchmark.families.one_net_toy`` in ``sys.modules``: the port's
``GenericDistiller`` KA-distilling a small conv net into a narrower one
(the student alone trains, under one Adam, with no discriminator), and a
plain reference of the same steps."""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import types
from typing import Dict

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import compare, control, inputs, run
from benchmark.families import common
from benchmark.families.common import CHECK_STEPS, seeded_weights
from benchmark.reference import inception_ka as ref
from benchmark.tests.tiny import REPO, limits

FAMILY = "one_net_toy"
CELL = "toy.f32_b4"
TAPS = ("h1", "h2")
FAULTS = ("unchanged", "half_batch", "altered")


def _shapes(width: int) -> Dict:
    return {"c1.weight": ((width, 3, 3, 3), "conv"), "c1.bias": ((width,), "bias"),
            "c2.weight": ((width, width, 3, 3), "conv"), "c2.bias": ((width,), "bias"),
            "c3.weight": ((3, width, 1, 1), "conv"), "c3.bias": ((3,), "bias")}


def _std(width: int) -> Dict[str, float]:  # He-normal, so the taps carry signal
    return {"c1.weight": math.sqrt(2 / 27), "c2.weight": math.sqrt(2 / (9 * width)),
            "c3.weight": math.sqrt(1 / width)}


class Toy(nn.Module):
    """conv 3x3, ReLU, conv 3x3, ReLU, conv 1x1, tanh; taps after each ReLU."""

    def __init__(self, width: int):
        super().__init__()
        self.c1 = nn.Conv2d(3, width, 3, padding=1)
        self.c2 = nn.Conv2d(width, width, 3, padding=1)
        self.c3 = nn.Conv2d(width, 3, 1)

    def forward(self, x, taps=()):
        h1 = F.relu(self.c1(x))
        h2 = F.relu(self.c2(h1))
        out = torch.tanh(self.c3(h2))
        acts = {"h1": h1, "h2": h2}
        return out, {t: acts[t] for t in taps}


def _toy_reference(p, x, q=(None, None)):
    """The same net, plain: each conv's operands through the control's
    rounding ``q`` (``reference/inception_ka.py::quantiser``)."""
    qf, gq = q[0] or (lambda t: t), q[1] or (lambda t: t)

    def conv(t, name, pad):
        return gq(F.conv2d(qf(t), qf(p[f"{name}.weight"]), p[f"{name}.bias"], padding=pad))

    h1 = conv(x, "c1", 1).clamp_min(0)
    h2 = conv(h1, "c2", 1).clamp_min(0)
    return torch.tanh(conv(h2, "c3", 0)), {"h1": h1, "h2": h2}


class Cell(common.TrainingCell):
    def __init__(self, config, traffic, seed, device, program=True):
        c, t = config, traffic
        self.config, self.traffic, self.device = c, t, device
        self.batch, self.size, self.lr = t["batch"], c["size"], c["lr"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.teacher_p = seeded_weights(_shapes(c["teacher_width"]), gen, device, False,
                                        _std(c["teacher_width"]))
        self.student_p = seeded_weights(_shapes(c["student_width"]), gen, device, False,
                                        _std(c["student_width"]))
        bank = inputs.make_bank({"x": {"kind": "image", "shape": [3, self.size, self.size]}},
                                self.batch, t["bank"], gen, device)
        self.bank = [(b["x"],) for b in bank]
        if not program:
            return
        from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams

        teacher, student = Toy(c["teacher_width"]), Toy(c["student_width"])
        teacher.load_state_dict(self.teacher_p)
        student.load_state_dict(self.student_p)
        hp = GenericDistillHParams(lambda_recon=c["lambda_recon"], beta1=c["beta1"],
                                   mapping_layers=TAPS, compute_dtype=t["compute_dtype"])
        self.dist = GenericDistiller(teacher, student, {}, {}, hp, device=device)
        self.state, self.tparams = self.dist.init_state(seed)
        self.record = self.check_steps()

    def trained(self):
        return (("G", self.state.opt, self.state.params),)

    def work(self):
        return {"flops_per_step": 1, "images_per_step": self.batch,
                "dtype": self.traffic["compute_dtype"], "norm_fwd_values": [],
                "norm_bwd_values": [], "grams": []}

    def reference(self, precision=None):
        prec = precision or {}
        q = ref.quantiser(prec.get("precision"), prec.get("grad_precision"))
        c = self.config
        with ref.exact_float32():
            tp = {k: v.float() for k, v in self.teacher_p.items()}
            sp = {k: v.float().clone().requires_grad_(True) for k, v in self.student_p.items()}
            start = {k: v.detach().clone() for k, v in sp.items()}
            opt = ref.Adam(sp, c["beta1"])
            losses, first = [], {}
            for (x,) in self.bank[:CHECK_STEPS]:
                with torch.no_grad():
                    t_out, t_acts = _toy_reference(tp, x, q)
                s_out, s_acts = _toy_reference(sp, x, q)
                l_rec = (s_out - t_out).square().mean() * c["lambda_recon"]
                parts = {f"Specific_loss/distill{i}": -ref.ka(s_acts[t], t_acts[t], q)
                         for i, t in enumerate(TAPS)}
                l_dis = sum(parts.values())
                grads = dict(zip(sp, torch.autograd.grad(l_rec + l_dis, list(sp.values()))))
                opt.step(grads, self.lr)
                if not first:
                    first = {f"G:{k}": v for k, v in ref.leaf_norms(grads).items()}
                losses.append({k: float(v.detach()) for k, v in {
                    "G_loss/recon": l_rec, "G_loss/distill": l_dis, **parts}.items()})
            change = {f"G:{k}": float((v.detach() - start[k]).double().norm())
                      for k, v in sp.items()}
        return {"losses": losses, "first_grad": first, "change": change}


def _fault(name: str):
    from cat_tpu_torch.distill.generic import GenericDistiller

    if name == "altered":  # the student's image scaled where it is produced
        forward = Toy.forward

        def scaled(self, x, taps=()):
            out, acts = forward(self, x, taps)
            return (out * 0.9 if self.training else out), acts
        return common._patched(Toy, "forward", scaled)
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    return common.fault(name, GenericDistiller, Toy)



def _module() -> types.ModuleType:
    m = types.ModuleType(f"benchmark.families.{FAMILY}")
    m.NETS, m.FAULTS, m.AFTER_UPDATE = ("G",), FAULTS, ()
    m.Cell = Cell
    m.setup = lambda config, traffic, seed, device, program=True: Cell(
        config, traffic, seed, device, program)
    m.fault = _fault
    return m


@pytest.fixture(scope="module")
def family():
    name = f"benchmark.families.{FAMILY}"
    assert name not in sys.modules
    sys.modules[name] = _module()
    yield sys.modules[name]
    del sys.modules[name]


@pytest.fixture(scope="module")
def root(family, tmp_path_factory):
    """A checkout with the repo's ``BENCHMARK.json`` plus the toy's entries,
    and the toy's configuration, traffic and limits as new files."""
    d = tmp_path_factory.mktemp("one_net")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    old = copy.deepcopy(bench)
    bench["configs"].append({"name": "toy", "source": "a CPU test's toy",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a conv net KA-distilled into a narrower one"})
    bench["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy_f32_b4",
                               "chips": 1, "why": "a CPU test's one-network cell"})
    for section, names in (("end_to_end", {"images_per_s"}), ("per_layer", {"mfu_pct"})):
        for m in bench[section]:
            if m["name"] in names:
                m["workloads"].append(CELL)
    files = {
        "BENCHMARK.json": bench,
        "benchmark/configs/toy.json": {"family": FAMILY, "teacher_width": 8, "student_width": 4,
                                       "size": 8, "lr": 2e-4, "beta1": 0.5, "lambda_recon": 5.0},
        "benchmark/traffic/toy_f32_b4.json": {"batch": 4, "compute_dtype": "float32", "bank": 4,
                                              "warmup_steps": 1, "print_freq": 2,
                                              "trace_steps": 2},
        f"benchmark/limits/{CELL}.json": {"limits": limits(family.NETS),
                                          "control": {"precision": "bfloat16"}},
    }
    for path, obj in files.items():
        os.makedirs(os.path.dirname(os.path.join(d, path)) or str(d), exist_ok=True)
        with open(os.path.join(d, path), "w") as f:
            json.dump(obj, f)
    # every entry the repo had is there as it was, a cell name appended at most
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for a, b in zip(old[section], bench[section]):
            assert a == {**b, **({"workloads": b["workloads"][:len(a["workloads"])]}
                                 if "workloads" in a else {})}
    return str(d)


def _run(root, seed=2 ** 31 + 11, trace=0):
    return run.run(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3",
                    "--trace", str(trace)], device_override="cpu", root=root)


def test_one_net_cell_is_correct(root, family):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_gap", "grad_gap.G", "change_gap.G", "student_arch"}
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}
    assert _run(root, seed=5, trace=1)["correct"]


def _spec(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = run.load_cell(json.load(f), CELL, root)
    return spec["config"], spec["traffic"]


def test_one_net_family_declares_no_d(family):
    assert family.NETS == ("G",) and "unchanged_d" not in family.FAULTS
    assert control.compared(family) == ("loss_gap", "grad_gap.G", "change_gap.G")
    assert "grad_gap.D" not in limits(family.NETS)


@pytest.mark.parametrize("fault", FAULTS)
def test_one_net_fault_is_not_correct(root, family, fault):
    with family.fault(fault):
        r = _run(root)
    assert not r["correct"], (fault, r["checks"])


def test_one_net_control_is_not_correct(root, family):
    """The reference in bf16 in the program's place fails the comparison."""
    c = family.setup(*_spec(root), 11, torch.device("cpu"), program=False)
    numbers = compare.training_gaps(c.reference({"precision": "bfloat16"}), c.reference())
    assert not compare.judge(numbers, {k: v for k, v in limits(family.NETS).items()
                                       if k != "student_arch"})


def test_one_net_readings(root, family, tmp_path, capsys):
    """``control`` runs the family's modes, refuses ``unchanged_d``, and
    reduces its rows on its own three numbers."""
    rows = {}
    for mode, seeds in (("program", ["3", "4"]), ("control", ["3"]), ("unchanged", ["3"])):
        out = str(tmp_path / f"{mode}.json")
        assert control.main(["--workload", CELL, "--mode", mode, "--seeds", *seeds, "--device",
                             "cpu", "--root", root, "--out", out]) == 0
        with open(out) as f:
            rows[mode] = json.load(f)
    with pytest.raises(SystemExit):
        control.main(["--workload", CELL, "--mode", "unchanged_d", "--seeds", "3", "--device",
                      "cpu", "--root", root])
    got = control.readings(rows, family)
    assert set(got["lower"]) == set(got["control"]) == {"loss_gap", "grad_gap.G",
                                                        "change_gap.G"}
    assert got["unchanged"]["grad_gap.G"] > 0.5 and "grad_gap.G" in got["upper"]
    assert all(r["grad_gap.G"] < 1e-4 for r in rows["program"])
