"""Cells of CAT's KA distillation of an inception (CycleGAN/pix2pix-style)
generator: the step of ``python -m cat_tpu_torch distill --distiller
inception``, ``InceptionDistiller.train_step``, driven on batches on the card.

Set-up does what the distill verb does before its first iteration, from
weights the benchmark seeds: the teacher (norm scales spread, as a trained
teacher's are), the FLOPs-targeted shrink to the student (sliced from the
teacher, as ``--restore_pretrained_G_path`` with ``--target_flops`` warm-starts
it), D, and the distiller's state.  Each layer's set of scale values is
fixed and the seed only orders it, so every seed shrinks to the same
student and gives the same work.

Then it drives that one state through its first steps on distinct batches
of the bank, recording what ``compare.py`` compares, and hands the same
state to the window.  After the window, ``reference`` frees the program
and replays those steps with ``reference/inception_ka.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import inputs
from benchmark.families import common
from benchmark.families.common import CHECK_STEPS, seeded_weights
from benchmark.reference import inception_ka as ref
from benchmark.yardstick import flops as work
# the first step's loss terms read through an updated network: the G
# loss's GAN term goes through D after D's update
AFTER_UPDATE = ("G_loss/gan",)


def _arch_of(cfg) -> Dict:
    """A program config as the reference's architecture dict."""
    blocks = [{"res": [c for _, c, _ in b.active_res], "res_k": [k for _, _, k in b.active_res],
               "dw": [c for _, c, _ in b.active_dw], "dw_k": [k for _, _, k in b.active_dw]}
              for b in cfg.blocks]
    return {"input_nc": cfg.input_nc, "output_nc": cfg.output_nc, "ds": list(cfg.ds_channels),
            "us": list(cfg.us_channels), "blocks": blocks}


class Cell(common.TrainingCell):
    """One cell's seeded weights, bank, program state and check records."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device, program: bool = True):
        from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
        from cat_tpu_torch.core.config import (InceptionGeneratorConfig,
                                               NLayerDiscriminatorConfig, NormConfig)
        from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

        c, t = config, traffic
        self.config, self.traffic, self.device = c, t, device
        self.batch, self.size = t["batch"], c["crop_size"]
        self.lr = c["lr"]
        self.taps = ["encode"] + [f"block{i}" for i in range(2, c["n_blocks"], 3)]
        self.teacher_arch = ref.teacher_arch(c["input_nc"], c["output_nc"], c["teacher_ngf"],
                                             c["channels_reduction_factor"], c["kernel_sizes"],
                                             c["n_blocks"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.teacher_p = seeded_weights(ref.generator_shapes(self.teacher_arch), gen, device, True)
        self.d_p = seeded_weights(ref.nlayer_shapes(c["output_nc"], c["ndf"], c["n_layers_D"],
                                                    c["norm_affine_D"]), gen, device, False)
        fields = {k: {"kind": "image", "shape": [c["input_nc"], self.size, self.size]}
                  for k in ("A", "B")}
        self.bank = inputs.make_bank(fields, self.batch, t["bank"], gen, device)
        if not program:
            return

        # --- the program, as the distill verb sets it up ---
        norm = NormConfig(kind="instance", affine=c["norm_affine"], track_running_stats=False)
        teacher_cfg = InceptionGeneratorConfig.make(
            input_nc=c["input_nc"], output_nc=c["output_nc"], ngf=c["teacher_ngf"],
            channels_reduction_factor=c["channels_reduction_factor"],
            kernel_sizes=tuple(c["kernel_sizes"]), n_blocks=c["n_blocks"], norm=norm)
        shrunk = shrink_generator(teacher_cfg, self.teacher_p, c["target_flops"], self.size,
                                  self.size, PruneBounds(cin_lb=c["prune_cin_lb"]))
        self.program_student = _arch_of(shrunk.config)
        disc_cfg = NLayerDiscriminatorConfig(
            input_nc=c["output_nc"], ndf=c["ndf"], n_layers=c["n_layers_D"],
            norm=NormConfig(kind="instance", affine=c["norm_affine_D"]))
        hp = DistillHParams(dataset_mode="unaligned", gan_mode=c["gan_mode"],
                            distill_loss_type="ka", lambda_recon=c["lambda_recon"],
                            lambda_distill=c["lambda_distill"], beta1=c["beta1"],
                            mapping_layers=tuple(self.taps), compute_dtype=t["compute_dtype"],
                            fused_norms=t["fused_norms"], packed_blocks=t["packed_blocks"])
        self.dist = InceptionDistiller(teacher_cfg, shrunk.config, disc_cfg, hp, device=device)
        self.state, self.tparams = self.dist.init_state(self.teacher_p, shrunk.state_dict,
                                                        self.d_p, seed=seed)
        del shrunk
        self.record = self.check_steps()

    # ----------------------------------------------------------- the yardstick

    def work(self) -> Dict:
        """What the per-layer metrics read: the step's operations, the
        precision of its convolutions, the fused norm sites and the Gram
        operands of one step."""
        b, hw = self.batch, self.size
        student = self.program_student
        dtype = self.traffic["compute_dtype"]
        sites_fwd, sites_bwd = [], []
        if self.traffic["fused_norms"] and self.config["norm_affine"]:
            t_planes = work.trunk_norm_planes(self.teacher_arch, hw, hw)
            s_planes = work.trunk_norm_planes(student, hw, hw)
            sites_fwd = [b * v for v in t_planes + s_planes]
            sites_bwd = [b * v for v in s_planes]
        t_taps = work.generator_taps(self.teacher_arch, hw, hw, self.taps)
        s_taps = work.generator_taps(student, hw, hw, self.taps)
        grams = [(b, t_taps[k]) for k in self.taps] + [(b, s_taps[k]) for k in self.taps]
        d = {"input_nc": self.config["output_nc"], "ndf": self.config["ndf"],
             "n_layers": self.config["n_layers_D"]}
        return {
            "flops_per_step": work.inception_ka_step_flops(self.teacher_arch, student, d, b,
                                                           hw, hw, self.taps),
            "images_per_step": b,
            "dtype": dtype,
            "norm_fwd_values": sites_fwd, "norm_bwd_values": sites_bwd,
            "grams": grams,
        }

    # ------------------------------------------------------------ the check

    def reference(self, precision=None) -> Dict:
        """The reference's record of the same steps from the same weights,
        its own shrink included; ``student_arch`` is 0 when the program's
        student has the reference's channels.  ``precision``: the control's
        (``reference/inception_ka.py::quantiser``)."""
        c = self.config
        arch, student_p = ref.shrink(self.teacher_arch, self.teacher_p, c["target_flops"],
                                     self.size, self.size, c["prune_cin_lb"])
        hp = {"beta1": c["beta1"], "taps": self.taps, "lambda_gan": 1.0,
              "lambda_recon": c["lambda_recon"], "lambda_distill": c["lambda_distill"]}
        out = ref.run_steps(self.teacher_p, self.teacher_arch, student_p, arch, self.d_p,
                            c["n_layers_D"], self.bank[:CHECK_STEPS], hp, self.lr, precision)
        if self.record is not None:
            out["student_arch"] = 0.0 if arch == self.program_student else 1.0
        return out


def setup(config: Dict, traffic: Dict, seed: int, device, program: bool = True) -> Cell:
    """The cell's seeded weights and bank and, with ``program``, the
    program's state after its first steps."""
    return Cell(config, traffic, seed, device, program)


def fault(name: str):
    """The program's step with fault ``name`` planted (``common.fault``)."""
    from cat_tpu_torch.distill.inception_distiller import InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator

    return common.fault(name, InceptionDistiller, InceptionGenerator)
