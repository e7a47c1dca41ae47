"""Cells of CAT's KA distillation of GauGAN's inception-SPADE generator: the
step of ``python -m cat_tpu_torch distill --distiller spade``,
``SPADEDistiller.train_step``, driven on batches on the card.

Set-up does what the distill verb does before its first iteration, from
weights the benchmark seeds: the teacher (norm scales spread, as a trained
teacher's are; running statistics calibrated on the first batch, as a
trained teacher's describe its data), the FLOPs-targeted shrink to the
student's widths, the student's weights (seeded: the recipe's magnitude
transfer from the teacher is set-up that changes no shape), the multiscale
spectral D, VGG19, and the distiller's state.  Each norm layer's set of
scale values is fixed and the seed only orders it, so every seed shrinks
to the same student and gives the same work.

Then, as ``inception_ka``, it drives that one state through its first
steps on distinct batches of the bank, records what ``compare.py``
compares, and hands the same state to the window; ``reference`` replays
those steps with ``reference/spade_ka.py``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import inputs
from benchmark.families import common
from benchmark.families.common import CHECK_STEPS, seeded_weights
from benchmark.reference import spade_ka as ref
from benchmark.yardstick import flops as work

# the first step's loss terms read through an updated network: the D
# update's losses are taken on a fake the updated student regenerates
AFTER_UPDATE = ("D_loss/fake", "D_loss/real")


def _arch_of(cfg) -> Dict:
    """A program config as the reference's architecture dict."""
    blocks = []
    for name, b in zip(cfg.block_names, cfg.blocks):
        nb = {"name": name, "fin": b.fin, "fout": b.fout}
        for key, active in (("res", b.active_res), ("dw", b.active_dw),
                            ("sp_res", b.spade.active_res), ("sp_dw", b.spade.active_dw)):
            nb[key] = [c for _, c, _ in active]
            nb[f"{key}_k"] = [k for _, _, k in active]
        blocks.append(nb)
    return {"semantic_nc": cfg.semantic_nc, "output_nc": cfg.output_nc, "fc": cfg.fc_channels,
            "crop": cfg.crop_size, "aspect": cfg.aspect_ratio, "blocks": blocks}


class Cell(common.TrainingCell):
    """One cell's seeded weights, bank, program state and check records."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, program: bool = True):
        c, t = config, traffic
        self.config, self.traffic, self.device = c, t, device
        self.batch, self.lr = t["batch"], c["lr"]
        self.taps = list(c["mapping_layers"])
        sem_nc = c["input_nc"] + int(c["contain_dontcare_label"]) + 1
        self.teacher_arch = ref.teacher_arch(sem_nc, c["teacher_ngf"],
                                             c["channels_reduction_factor"], c["kernel_sizes"],
                                             c["crop_size"], c["aspect_ratio"])
        self.height = round(c["crop_size"] / c["aspect_ratio"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.teacher_p = seeded_weights(ref.generator_shapes(self.teacher_arch), gen, device,
                                        True)
        d_shapes = ref.discriminator_shapes(sem_nc + 3, c["ndf"], c["n_layers_D"], c["num_D"])
        self.d_p = seeded_weights(d_shapes, gen, device, False)
        v_shapes = ref.vgg_shapes()
        self.vgg_p = seeded_weights(v_shapes, gen, device, False, {  # He-normal
            k: math.sqrt(2.0 / math.prod(s[1:])) for k, (s, kind) in v_shapes.items()
            if kind == "conv"})
        fields = {"label": {"kind": "regions", "shape": [self.height, c["crop_size"]],
                            "classes": c["input_nc"] + 1, "regions": t["regions"]},
                  "instance": {"kind": "instances", "shape": [self.height, c["crop_size"]],
                               "regions": t["regions"]},
                  "image": {"kind": "image", "shape": [3, self.height, c["crop_size"]]}}
        self.bank = inputs.make_bank(fields, self.batch, t["bank"], gen, device)
        sem0 = ref.semantics(self.bank[0]["label"], self.bank[0]["instance"], c["input_nc"])
        self.teacher_p.update(ref.calibrate_stats(self.teacher_p, self.teacher_arch, sem0))
        del sem0
        self.student_arch = ref.shrink(self.teacher_arch, self.teacher_p, c["target_flops"],
                                       c["prune_cin_lb"])
        self.student_p = seeded_weights(ref.generator_shapes(self.student_arch), gen, device,
                                        False)
        self.program_student = None
        if program:
            self._program(seed)

    def _program(self, seed: int) -> None:
        """The program's distiller and state, as the distill verb sets them
        up, and its first steps."""
        from cat_tpu_torch.compress.shrink import PruneBounds
        from cat_tpu_torch.compress.spade import shrink_spade_generator
        from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                     SPADEGeneratorConfig)
        from cat_tpu_torch.distill.spade_distiller import SPADEDistiller, SPADEDistillHParams
        from cat_tpu_torch.models.vgg import VGG19Features

        c, t = self.config, self.traffic
        arch = self.teacher_arch
        teacher_cfg = SPADEGeneratorConfig.make(
            semantic_nc=arch["semantic_nc"], ngf=c["teacher_ngf"],
            channels_reduction_factor=c["channels_reduction_factor"],
            kernel_sizes=tuple(c["kernel_sizes"]), num_upsampling_layers="more",
            crop_size=c["crop_size"], aspect_ratio=c["aspect_ratio"],
            param_free_norm="syncbatch", spectral=False, active_fn="leaky_relu")
        shrunk = shrink_spade_generator(teacher_cfg, self.teacher_p, c["target_flops"],
                                        self.height, c["crop_size"],
                                        PruneBounds(cin_lb=max(c["prune_cin_lb"], 1)))
        self.program_student = _arch_of(shrunk.config)
        if self.program_student != self.student_arch:
            return  # its weights would not fit: ``student_arch`` reads 1
        d_cfg = MultiscaleDiscriminatorConfig(input_nc=arch["semantic_nc"] + 3, ndf=c["ndf"],
                                              n_layers=c["n_layers_D"], num_D=c["num_D"],
                                              norm_D=c["norm_D"])
        hp = SPADEDistillHParams(
            gan_mode=c["gan_mode"], distill_loss_type="ka", lambda_distill=c["lambda_distill"],
            lambda_feat=c["lambda_feat"], lambda_vgg=c["lambda_vgg"], beta1=c["beta1"],
            beta2=c["beta2"], init_type=c["init_type"], mapping_layers=tuple(self.taps),
            compute_dtype=t["compute_dtype"], vgg_compute_dtype=t["vgg_compute_dtype"],
            packed_blocks=t["packed_blocks"])
        vgg = VGG19Features()
        vgg.load_state_dict(self.vgg_p)
        self.dist = SPADEDistiller(teacher_cfg, shrunk.config, d_cfg, hp, vgg=vgg,
                                   input_nc=c["input_nc"],
                                   contain_dontcare=c["contain_dontcare_label"], device=self.device)
        self.state, self.tparams = self.dist.init_state(self.teacher_p, self.student_p, self.d_p,
                                                        seed=seed)
        self.record = self.check_steps()

    def work(self) -> Dict:
        c = self.config
        d = {"input_nc": self.teacher_arch["semantic_nc"] + 3, "ndf": c["ndf"],
             "n_layers": c["n_layers_D"], "num_D": c["num_D"]}
        t_taps = work.spade_taps(self.teacher_arch, self.taps)
        s_taps = work.spade_taps(self.student_arch, self.taps)
        dtype = self.traffic["compute_dtype"]
        return {
            "flops_per_step": work.spade_ka_step_flops(self.teacher_arch, self.student_arch, d,
                                                       self.batch, self.taps),
            "images_per_step": self.batch,
            "dtype": dtype,
            "norm_fwd_values": [], "norm_bwd_values": [],
            "grams": [(self.batch, t_taps[k]) for k in self.taps]
            + [(self.batch, s_taps[k]) for k in self.taps],
        }

    def reference(self, precision=None) -> Dict:
        """The reference's record of the same steps from the same weights;
        ``student_arch`` is 0 when the program's shrink gave the reference's
        widths."""
        c = self.config
        hp = {"taps": self.taps, "label_nc": c["input_nc"], "n_layers_D": c["n_layers_D"],
              "num_D": c["num_D"], "beta1": c["beta1"], "beta2": c["beta2"],
              "lambda_gan": 1.0, "lambda_feat": c["lambda_feat"], "lambda_vgg": c["lambda_vgg"],
              "lambda_distill": c["lambda_distill"]}
        out = ref.run_steps(self.teacher_p, self.teacher_arch, self.student_p, self.student_arch,
                            self.d_p, self.vgg_p, self.bank[:CHECK_STEPS], hp, self.lr, precision)
        if self.program_student is not None:
            out["student_arch"] = 0.0 if self.program_student == self.student_arch else 1.0
        return out


def setup(config: Dict, traffic: Dict, seed: int, device, program: bool = True) -> Cell:
    """The cell's seeded weights and bank and, with ``program``, the
    program's state after its first steps."""
    return Cell(config, traffic, seed, device, program)


def fault(name: str):
    """The program's step with fault ``name`` planted (``common.fault``)."""
    from cat_tpu_torch.distill.spade_distiller import SPADEDistiller
    from cat_tpu_torch.models.spade import SPADEGenerator

    return common.fault(name, SPADEDistiller, SPADEGenerator)
