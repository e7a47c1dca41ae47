"""Cells of the KA distillation of ADM's 256x256 diffusion UNet
(openai/guided-diffusion's ``UNetModel``, image-conditioned as Palette)
into a half-width student: ``GenericDistiller.train_step`` on
``cat_tpu_torch/models/adm.py``, driven on batches on the card.

Set-up seeds both nets' weights (kernels fan-in-scaled normals,
``reference/adm_ka.py::stds``; biases and GroupNorm shifts 0, scales 1),
builds the two UNets on the ``meta`` device and hands them the seeded
tensors, makes the bank (below) and the distiller's state.  Then, as the
other families, it drives that state through its first steps, recording
what ``compare.py`` compares, and hands the same state to the window;
``reference`` replays those steps with ``reference/adm_ka.py``.

The bank is DDPM's forward process on seeded images: for each image a
clean target x0 and a source image (``inputs.make_bank``'s ``image``
kind), a timestep t uniform over the traffic's ``diffusion_steps`` and a
noise ε, x_t = √ᾱ_t·x0 + √(1-ᾱ_t)·ε under the linear β schedule, and the
net's input cat(x_t, source) on the channel axis.  A batch is (x, t).

The check compares the student twice: whole (``G``), and its GroupNorm
scales γ alone (``G_scales``), a net of their own to ``compare.py``.  On
some seeds the bf16 step's whole gradient is off the float32 reference's
by a common factor (up to ~0.7%: seeded nets whose KA sits near its
maximum and whose outputs nearly cancel), which ``grad_gap.G`` reads and
Adam's update, blind to the gradient's scale, does not.  What survives in
the change is rounding element by element, which fp8 brings and bf16 does
not; the per-channel scales show it most (``change_gap.G_scales``).
"""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import torch

from benchmark import inputs
from benchmark.families import common
from benchmark.families.common import CHECK_STEPS, seeded_weights
from benchmark.reference import adm_ka as ref
from benchmark.yardstick import adm as work

# the network the step trains, the student (KA needs no adaptor), and its
# GroupNorm scales compared apart (above)
NETS = ("G", "G_scales")
FAULTS = ("unchanged", "half_batch", "altered")
AFTER_UPDATE = ()
NET_KEYS = ("image_size", "in_channels", "out_channels", "num_res_blocks",
            "attention_resolutions", "channel_mult", "num_head_channels")


def net(config: Dict, width: int) -> Dict:
    """One net of the configuration at ``model_channels`` ``width``."""
    return {**{k: config[k] for k in NET_KEYS}, "model_channels": width}


def bank(config: Dict, traffic: Dict, batch: int, gen: torch.Generator,
         device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The traffic's batches of (cat(x_t, source), t), drawn from ``gen``."""
    hw = config["image_size"]
    image = {"kind": "image", "shape": [3, hw, hw]}
    raw = inputs.make_bank({"x0": image, "source": image}, batch, traffic["bank"], gen, device)
    n = batch * traffic["bank"]
    steps = traffic["diffusion_steps"]
    t = torch.randint(0, steps, (n,), generator=gen, device=device)
    eps = torch.randn((n, 3, hw, hw), generator=gen, device=device)
    betas = torch.linspace(traffic["beta_start"], traffic["beta_end"], steps, dtype=torch.float64)
    abar = torch.cumprod(1.0 - betas, 0).to(device)[t].float()[:, None, None, None]
    out = []
    for i, b in enumerate(raw):
        rows = slice(i * batch, (i + 1) * batch)
        x_t = abar[rows].sqrt() * b["x0"] + (1.0 - abar[rows]).sqrt() * eps[rows]
        out.append((torch.cat([x_t, b["source"]], 1), t[rows]))
    return out


def scales(spec: Dict) -> List[str]:
    """The GroupNorm scales (γ) of a net, by name."""
    return [k for k, (_, kind) in ref.shapes(spec).items() if kind == "scale"]


class _Moments:
    """The first moments of some of an optimiser's parameters (``mu``, in
    their order): what ``check_steps`` reads of a net."""

    def __init__(self, mu: List[torch.Tensor]):
        self.mu = mu


class Cell(common.TrainingCell):
    """One cell's seeded weights, bank, program state and check records."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, program: bool = True):
        c, t = config, traffic
        self.config, self.traffic, self.device = c, t, device
        self.batch, self.size, self.lr = t["batch"], c["image_size"], c["lr"]
        self.taps = list(c["taps"])
        self.teacher = net(c, c["teacher_model_channels"])
        self.student = net(c, c["student_model_channels"])
        gen = torch.Generator(device=device).manual_seed(seed)
        t_shapes, s_shapes = ref.shapes(self.teacher), ref.shapes(self.student)
        self.teacher_p = seeded_weights(t_shapes, gen, device, False, ref.stds(t_shapes))
        self.student_p = seeded_weights(s_shapes, gen, device, False, ref.stds(s_shapes))
        self.bank = bank(c, t, self.batch, gen, device)
        if not program:
            return

        # --- the program ---
        from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams
        from cat_tpu_torch.models.adm import ADMConfig, ADMUNet

        def build(spec, weights):
            cfg = ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in spec.items()})
            with torch.device("meta"):
                m = ADMUNet(cfg)
            m.load_state_dict(weights, assign=True)
            return m

        teacher = build(self.teacher, self.teacher_p)
        student = build(self.student, {k: v.clone() for k, v in self.student_p.items()})
        hp = GenericDistillHParams(distill_loss_type="ka", recon_loss_type=c["recon_loss_type"],
                                   lambda_recon=c["lambda_recon"],
                                   lambda_distill=c["lambda_distill"], beta1=c["beta1"],
                                   beta2=c["beta2"], mapping_layers=tuple(self.taps),
                                   compute_dtype=t["compute_dtype"])
        self.dist = GenericDistiller(teacher, student, teacher.cfg.tap_widths(),
                                     student.cfg.tap_widths(), hp, device=device)
        self.state, self.tparams = self.dist.init_state(seed)
        self.program_student = {k: tuple(v.shape) for k, v in self.state.params.items()}
        self.record = self.check_steps()

    def trained(self):
        params, opt = self.state.params, self.state.opt
        moments = dict(zip(params, opt.mu))
        names = scales(self.student)
        return (("G", opt, params),
                ("G_scales", _Moments([moments[k] for k in names]),
                 {k: params[k] for k in names}))

    # ----------------------------------------------------------- the yardstick

    def work(self) -> Dict:
        """The step's operations, the Gram operands, the attention sites
        (forward in both nets, backward in the student) and the GroupNorm
        values of one step."""
        b, hw = self.batch, self.size
        t_taps = work.tap_values(self.teacher, hw, self.taps)
        s_taps = work.tap_values(self.student, hw, self.taps)
        t_attn = work.attention_sites(self.teacher, hw)
        s_attn = work.attention_sites(self.student, hw)
        return {
            "flops_per_step": work.ka_step_flops(self.teacher, self.student, b, hw, self.taps),
            "images_per_step": b,
            "dtype": self.traffic["compute_dtype"],
            "norm_fwd_values": [], "norm_bwd_values": [],
            "grams": [(b, t_taps[k]) for k in self.taps] + [(b, s_taps[k]) for k in self.taps],
            "attention_fwd": [(b * h, n, d) for h, n, d in t_attn + s_attn],
            "attention_bwd": [(b * h, n, d) for h, n, d in s_attn],
        }

    # ------------------------------------------------------------ the check

    def reference(self, precision=None) -> Dict:
        """The reference's record of the same steps from the same weights;
        ``student_arch`` is 0 when the program's student has the
        reference's parameters, shape for shape.  ``precision``: the
        control's (``reference/inception_ka.py::quantiser``)."""
        c = self.config
        hp = {"taps": self.taps, "beta1": c["beta1"], "beta2": c["beta2"],
              "lambda_recon": c["lambda_recon"], "lambda_distill": c["lambda_distill"]}
        out = ref.run_steps(self.teacher_p, self.teacher, self.student_p, self.student,
                            self.bank[:CHECK_STEPS], hp, self.lr, precision)
        for part in ("first_grad", "change"):
            out[part].update({f"G_scales:{k}": out[part][f"G:{k}"] for k in scales(self.student)})
        if self.record is not None:
            mine = {k: s for k, (s, _) in ref.shapes(self.student).items()}
            out["student_arch"] = 0.0 if mine == self.program_student else 1.0
        return out


def tiny(config: Dict) -> Tuple[Dict, Dict]:
    """The configuration at toy widths (model_channels 64 and 32, the least
    that GroupNorm's 32 groups take at half width; three levels, attention
    at 8 x 8 in heads of 8 channels, 32 px) and a float32 traffic of batch
    4, for the CPU tests."""
    taps = ["input_blocks.5", "middle_block", "output_blocks.5", "output_blocks.8"]
    cfg = {**config, "image_size": 32, "teacher_model_channels": 64,
           "student_model_channels": 32, "channel_mult": [1, 2, 2],
           "attention_resolutions": [8], "num_head_channels": 8, "taps": taps}
    return cfg, {"batch": 4, "compute_dtype": "float32", "diffusion_steps": 1000,
                 "beta_start": 1e-4, "beta_end": 0.02, "bank": 4, "warmup_steps": 1,
                 "print_freq": 2, "trace_steps": 2}


def setup(config: Dict, traffic: Dict, seed: int, device, program: bool = True) -> Cell:
    """The cell's seeded weights and bank and, with ``program``, the
    program's state after its first steps.  On a card the objects alive at
    the end of set-up (~190k: the imports, both nets, the bank) are then
    frozen out of the collector: a full collection that scans them takes
    ~140 ms, during which the card drains its queue and waits (~0.6% of a
    window, in some windows and not others); frozen, it takes under 4 ms."""
    cell = Cell(config, traffic, seed, device, program)
    if program and torch.device(device).type == "cuda":
        gc.collect()
        gc.freeze()
    return cell


def fault(name: str):
    """The program's step with fault ``name`` planted: ``unchanged`` and
    ``half_batch`` as ``common.fault``; ``altered`` scales the UNet's ε by
    0.9 where autograd records (the student's forward, not the frozen
    teacher's, which runs under no_grad)."""
    from cat_tpu_torch.distill.generic import GenericDistiller
    from cat_tpu_torch.models.adm import ADMUNet

    if name == "altered":
        forward = ADMUNet.forward

        def scaled(self, x, t, taps=()):
            out = forward(self, x, t, taps)
            if not torch.is_grad_enabled():
                return out
            return (out[0] * 0.9, out[1]) if isinstance(out, tuple) else out * 0.9
        return common._patched(ADMUNet, "forward", scaled)
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    return common.fault(name, GenericDistiller, ADMUNet)
