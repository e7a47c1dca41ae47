"""Drive the PyTorch/CUDA port (``cat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

  1. device: requires CUDA; prints the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
  2. kernels: builds the hand-written CUDA kernels from ``cat_tpu_torch/csrc``
     (one nvcc per source, in parallel), then holds each against its plain
     PyTorch version in bf16 and f32 at the flagship step's shapes, and times
     kernel, plain version, one-call PyTorch yardstick and the bound (for
     the Gram, the lower triangle's B(B+1)·F flops, printed beside the full
     square's 2·B²·F counted before).  The bf16 Gram: the TMA + wgmma kernel
     the main path takes (also called twice for bit-identity) and the
     mma.sync kernel, both at the step's shapes and the latter also at an
     F % 8 != 0 shape.  The f32 Gram: the TMA + FMA kernel (bit-identity
     and exact symmetry checked) and the old FMA kernel, both at the step's
     shapes and the latter also at an F % 4 != 0 shape;
  3. reference: one float32 KA-distillation step at a tiny size on the card
     (kernels) and on the CPU (plain versions), losses compared;
  4. flagship: the horse2zebra KA-distillation step of ``bench.py`` (teacher
     ngf 64 / r6 / kernels 1,3,5; student shrunk to 2.6e9 MACs; 256 px;
     unaligned lsgan + KA over encode, block2, block5, block8; bf16 compute,
     float32 masters; packed blocks) at full width: 1 warm-up + 3 timed steps,
     the Gram's TMA kernel launched 8 times per step;
  5. fused norms: the same step with ``fused_norms=True`` for 2 steps, the
     norm kernel launched once per ConvNormAct (6 per step);
  6. distill verb: ``entry.distill_main`` with the flags of
     ``scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh`` (batch
     80, 2.6e9-MAC student, KA, lsgan, pretrained-G transfer and D restore)
     over a seeded unaligned dataset of 256x256 PNGs, 8 steps, twice: (a)
     float32 with the host loader, (b) bfloat16 with the device-resident
     bank.  The Gram kernel must launch 8 times per step (the f32 TMA + FMA
     kernel in (a), the bf16 TMA kernel in (b)) and is held against its
     plain version on the run's own (80, F) taps (in (a) also for
     bit-identity and symmetry, and timed beside the old FMA kernel); the
     checkpoints must exist and reload to the in-memory student's output
     exactly.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

BATCH = 128  # bench.py's batch
SIZE = 256
TIMED_STEPS = 3
FUSED_STEPS = 2
LR = 2e-4
VERB_BATCH = 80  # the student recipe's batch
VERB_IMAGES = 160  # per side: 2 steps per epoch
VERB_EPOCHS = 4
SLEEP_CYCLES = 4_000_000  # ~2 ms at 1.98 GHz: the host enqueues timed work meanwhile
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 FMA


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, flush, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls.  Each call
    is timed with CUDA events after ``flush()`` (which evicts the L2) and a
    device-side sleep, so the host has enqueued the whole call before the
    device reaches it: the time is the device's, not the wrapper's Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _check_gram(got, ref, what: str) -> float:
    """Max |got - ref|; fails beyond 1e-5 of the largest entry (float32
    sums in another order)."""
    import torch

    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())
    if not err <= tol or not torch.isfinite(got).all():
        fail(f"gram {what} {tuple(ref.shape)}: max |err| {err:g} > {tol:g}")
    return err


def gram_numbers(xs, flush, card, expect_path: str, compare_mma: bool = False):
    """Hold the Gram kernel against its plain version on each (B, F)
    operand of ``xs`` (a teacher and a student tap), which must take kernel
    ``expect_path``, and time kernel, plain version, one-call PyTorch
    yardstick and bound; returns the totals of one step (four taps, so four
    launches of each).  float32: also check that two calls are bit-identical
    and G == Gᵀ exactly, and hold and time the old FMA kernel beside
    (``fma_ms``).  ``compare_mma`` (bf16): check bit-identity, and hold and
    time the mma.sync kernel beside (``mma_sync_ms``).  The bound counts
    the lower triangle's B(B+1)·F flops, the least a symmetric Gram needs
    (``bound_full_square_ms``: the 2·B²·F counted before)."""
    import torch

    from cat_tpu_torch.distill import ka

    old_key = "fma_ms" if expect_path == "f32tma" else "mma_sync_ms"
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "bound_full_square_ms": 0.0, old_key: 0.0}
    for who, x in zip(("teacher", "student"), xs):
        b, f = x.shape
        dname = str(x.dtype).split(".")[-1]
        f32 = x.dtype == torch.float32
        path = ka._gram_path(b, f, x.dtype, x.data_ptr() % 16 == 0)
        if path != expect_path:
            fail(f"gram {who}: the {dname} operand {tuple(x.shape)} took path {path!r}, "
                 f"expected {expect_path!r}")
        if f32:
            def library():
                return torch.matmul(x, x.T)
            lib_name, old_path, old_name = "torch.matmul(x, x.T)", "f32", "FMA"
        else:
            def library():
                return torch.mm(x, x.T, out_dtype=torch.float32)
            lib_name, old_path, old_name = ("torch.mm(x, x.T, out_dtype=float32)", "mma",
                                            "mma.sync")
        ref = ka.gram_plain(x)
        got = ka.gram_cuda(x)
        err = _check_gram(got, ref, f"{who} {dname} {path}")
        old_ms = None
        if f32 or compare_mma:
            if not torch.equal(got, ka.gram_cuda(x)):
                fail(f"gram {who}: two calls of the {path} kernel differ")
            if f32 and not torch.equal(got, got.T):
                fail(f"gram {who}: the {path} kernel's result is not exactly symmetric")
            old_out = ka._gram_launch(x, old_path)
            _check_gram(old_out, ref, f"{who} {dname} {old_path}")
            # which float32 result is nearest the exact Gram
            r64 = x.double() @ x.double().T
            e64 = {k: float((v.double() - r64).abs().max()) for k, v in
                   (("kernel", got), (old_name, old_out), (lib_name, library()),
                    ("plain", ref))}
            del r64, old_out
            log(f"gram {who} {dname}: max |err| against float64: {e64}")
            old_ms = timed(lambda: ka._gram_launch(x, old_path), flush=flush)
        lib = timed(library, flush=flush)
        ms = timed(lambda: ka.gram_cuda(x), flush=flush)
        plain = timed(lambda: ka.gram_plain(x), flush=flush)
        bytes_ms = 1e3 * (b * f * x.element_size() + b * b * 4) / HBM_BYTES_PER_S
        ops_ms = 1e3 * b * (b + 1) * f / PEAK_FLOPS[dname]
        bound = max(bytes_ms, ops_ms)
        full = max(bytes_ms, 1e3 * 2 * b * b * f / PEAK_FLOPS[dname])
        old = f", {old_name} kernel {old_ms:.4f} ms" if old_ms is not None else ""
        log(f"gram {who:7s} {dname:8s} B={b} F={f}: kernel ({path}) {ms:.4f} ms "
            f"({100 * bound / ms:.1f}% of bound){old}, plain {plain:.4f} ms, {lib_name} "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'ops'}; "
            f"{full:.4f} ms with the full square counted), max|err| {err:.3g} (tol "
            f"{1e-5 * float(ref.abs().max()):.3g}) [{card}]")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                     ("bound_full_square_ms", full), (old_key, old_ms or 0.0)):
            tot[k] += 4 * v  # four taps per step
        tot["err"] = max(tot["err"], err)
    return tot


def check_kernels(dev, t_channels, s_channels, card):
    """Each kernel against its plain version in bf16 and f32 at the step's
    shapes; returns the per-step numbers of each kernel at the main path's
    dtype (bf16)."""
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def flush():
        l2.zero_()

    out = {}
    # --- Gram: one operand per launch; per tap a teacher and a student one.
    # bf16: the main path's kernel (TMA + wgmma), also called twice for
    # bit-reproducibility and timed beside the mma.sync kernel on the same
    # operand.  f32: the TMA + FMA kernel, checked the same way and for exact
    # symmetry, and timed beside the old FMA kernel.
    bc = t_channels[-1], s_channels[-1]
    for dtype in (torch.bfloat16, torch.float32):
        xs = [torch.relu(torch.randn(BATCH, 64 * 64 * c, generator=gen, device=dev)).to(dtype)
              for c in bc]
        bf16 = dtype == torch.bfloat16
        out[("gram", str(dtype).split(".")[-1])] = gram_numbers(
            xs, flush, card, "tma" if bf16 else "f32tma", compare_mma=bf16)
    # the old kernels stay the main path's for operands TMA cannot map: bf16
    # with F % 8 != 0 (mma.sync), float32 with F % 4 != 0 (FMA)
    for dtype, f, path in ((torch.bfloat16, 4096 * 3 + 4, "mma"),
                           (torch.float32, 4096 * 3 + 2, "f32")):
        x = torch.relu(torch.randn(BATCH, f, generator=gen, device=dev)).to(dtype)
        if ka._gram_path(*x.shape, x.dtype, True) != path:
            fail(f"gram: {dtype} with F = {f} did not select the {path!r} kernel")
        err = _check_gram(ka.gram_cuda(x), ka.gram_plain(x), f"{dtype} {path} F = {f}")
        log(f"gram {path} kernel on {tuple(x.shape)} {dtype}: max|err| {err:.3g}")

    # --- instance norm + affine + relu at stem / down0 / down1, both nets
    planes = [(c, SIZE >> j) for channels in (t_channels, s_channels)
              for j, c in enumerate(channels)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0}
        for c, hw in planes:
            x = (torch.randn(BATCH, c, hw, hw, generator=gen, device=dev) * 3 + 1).to(dtype)
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev)
            for act in ("relu", "leaky_relu"):
                got = inorm.instance_norm_act_cuda(x, scale, bias, 1e-5, act)
                ref = inorm.instance_norm_act_plain(x, scale, bias, 1e-5, act)
                torch.cuda.synchronize()
                # f32: statistics summed in another order; bf16: one unit in
                # the last place (relative 2^-7)
                rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
                diff = (got.float() - ref.float()).abs()
                excess = float((diff - rtol * ref.float().abs()).max())
                if not excess <= atol or not torch.isfinite(got).all():
                    fail(f"instance_norm_act {act} {dname} {tuple(x.shape)}: "
                         f"error beyond rtol {rtol:g} by {excess:g} > {atol:g}")
                if act == "relu":
                    tot["err"] = max(tot["err"], float(diff.max()))
            ms = timed(lambda: inorm.instance_norm_act_cuda(x, scale, bias), flush=flush)
            plain = timed(lambda: inorm.instance_norm_act_plain(x, scale, bias), flush=flush)
            # yardstick: norm + affine, without the ReLU: one call, less work
            lib = timed(lambda: torch.nn.functional.instance_norm(x, weight=scale, bias=bias,
                                                                  eps=1e-5), flush=flush)
            # one read and one write; ~10 flops per element on CUDA cores
            bytes_ms = 1e3 * 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
            ops_ms = 1e3 * 10 * x.numel() / PEAK_FLOPS["float32"]
            bound = max(bytes_ms, ops_ms)
            log(f"instance_norm_act {dname:8s} {tuple(x.shape)}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, F.instance_norm (norm + affine, no ReLU) {lib:.4f} ms, "
                f"bound {bound:.4f} ms, max|err| {float(diff.max()):.3g} "
                f"(tol rtol {rtol:g} + atol {atol:g}) [{card}]")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[k] += v
        out[("instance_norm_act", dname)] = tot
    del l2
    return out


# ---------------------------------------------------------------------------
# Phases 3-5: the KA-distillation step
# ---------------------------------------------------------------------------


def reference_check(dev):
    """One float32 step at a tiny size on the card and on the CPU, from the
    same weights and batch: the kernels in context against the plain
    versions."""
    import torch

    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator

    def cfg(ngf):
        return InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                             kernel_sizes=(1, 3, 5), n_blocks=2)

    teacher = InceptionGenerator(cfg(8), generator=torch.Generator().manual_seed(1))
    hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan", lambda_recon=5.0,
                        mapping_layers=("encode", "block1"), fused_norms=True,
                        packed_blocks=False)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    batch = {"A": x, "B": x.flip(0)}
    losses = []
    for d in (dev, torch.device("cpu")):
        dist = InceptionDistiller(cfg(8), cfg(4), NLayerDiscriminatorConfig(ndf=8), hp, d)
        state, tp = dist.init_state(teacher.state_dict(), seed=3)
        _, m = dist.train_step(state, tp, {k: v.to(d) for k, v in batch.items()}, LR)
        losses.append({k: float(v) for k, v in m.items()})
    for k in losses[1]:
        # float32 throughout (TF32 off): sums in another order only
        if not math.isclose(losses[0][k], losses[1][k], rel_tol=1e-4, abs_tol=1e-5):
            fail(f"tiny f32 step, {k}: card {losses[0][k]!r} vs CPU {losses[1][k]!r}")
    log(f"reference: tiny f32 step on the card matches the CPU's (rtol 1e-4): {losses[0]}")


def flagship():
    """bench.py's flagship teacher and its shrink; returns (teacher config,
    teacher state_dict, ShrinkResult)."""
    import numpy as np
    import torch

    from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NormConfig
    from cat_tpu_torch.models.generator import InceptionGenerator

    teacher_cfg = InceptionGeneratorConfig.make(
        ngf=64, channels=None, channels_reduction_factor=6, kernel_sizes=(1, 3, 5),
        n_blocks=9, norm=NormConfig(kind="instance", affine=True, track_running_stats=False),
    )
    teacher = InceptionGenerator(teacher_cfg, generator=torch.Generator().manual_seed(233))
    # spread the norm scales so the search has signal, as bench.py does
    rs = np.random.RandomState(0)
    sd = {}
    for k, v in teacher.state_dict().items():
        if v.dim() == 1 and k.endswith(".weight"):
            v = torch.from_numpy(rs.uniform(0.05, 2.0, v.shape).astype(np.float32))
        sd[k] = v
    res = shrink_generator(teacher_cfg, sd, 2.6e9, SIZE, SIZE, PruneBounds(cin_lb=16))
    log(f"student: {res.searched_macs} MACs at {SIZE} px (target 2.6e9), "
        f"ds {res.config.ds_channels}, us {res.config.us_channels}")
    return teacher_cfg, sd, res


def run_steps(dev, teacher_cfg, teacher_sd, student_cfg, fused, n_steps, card,
              profile_steps=0):
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.ops import instance_norm as inorm

    hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan", distill_loss_type="ka",
                        lambda_recon=5.0, lambda_distill=1.0, compute_dtype="bfloat16",
                        fused_norms=fused, packed_blocks=True)
    dist = InceptionDistiller(teacher_cfg, student_cfg, hp=hp, device=dev)
    state, tparams = dist.init_state(teacher_sd, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randn(BATCH, 3, SIZE, SIZE, generator=gen, device=dev) for k in "AB"}
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    inorm.launches = 0
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = dist.train_step(state, tparams, batch, LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"gram": ka.launches, "gram_tma": ka.path_launches["tma"],
              "instance_norm_act": inorm.launches}

    vals = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        fail(f"non-finite losses: {vals}")
    out = dist.generate_student(state, batch["A"][:2])
    if out.shape != (2, 3, SIZE, SIZE) or not torch.isfinite(out).all():
        fail(f"student output {tuple(out.shape)} not finite / wrong shape")
    busy_ms = None
    if profile_steps:
        busy_ms = profile(lambda: dist.train_step(state, tparams, batch, LR), profile_steps,
                          card)
    return times, counts, vals, torch.cuda.max_memory_allocated(), busy_ms


# ---------------------------------------------------------------------------
# Phase 6: the distill verb
# ---------------------------------------------------------------------------

# scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh, but for the
# paths and the schedule (no --real_stat_path, 4 epochs, a save at the end,
# losses printed every step)
RECIPE = ["--dataset_mode", "unaligned", "--distiller", "inception", "--gan_mode", "lsgan",
          "--teacher_ngf", "64", "--student_ngf", "20", "--ndf", "64",
          "--batch_size", str(VERB_BATCH), "--eval_batch_size", "2", "--norm_affine",
          "--norm_affine_D", "--channels_reduction_factor", "6", "--kernel_sizes", "1", "3", "5",
          "--lambda_distill", "1.0", "--lambda_recon", "5", "--prune_cin_lb", "16",
          "--target_flops", "2.6e9", "--distill_G_loss_type", "ka",
          "--nepochs", str(VERB_EPOCHS), "--nepochs_decay", "0",
          "--save_epoch_freq", str(VERB_EPOCHS), "--print_freq", "1"]


def write_verb_inputs(root, teacher_cfg, teacher_sd) -> None:
    """An unaligned dataset of seeded 256x256 PNGs (horse2zebra's size:
    the loader resizes to 286 and crops 256), and the teacher and an ndf-64
    D as the port's ``save_net`` writes them."""
    import numpy as np
    import torch
    from PIL import Image

    from cat_tpu_torch.core.config import NLayerDiscriminatorConfig, NormConfig
    from cat_tpu_torch.models.discriminators import NLayerDiscriminator
    from cat_tpu_torch.utils import checkpoint as ckpt

    rs = np.random.RandomState(0)
    for side, n in (("trainA", VERB_IMAGES), ("trainB", VERB_IMAGES), ("valA", 2), ("valB", 2)):
        d = os.path.join(root, "data", side)
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                os.path.join(d, f"{i}.png"))
    ckpt.save_net(os.path.join(root, "teacher"), "best_A", "G_A", teacher_sd, teacher_cfg)
    dcfg = NLayerDiscriminatorConfig(input_nc=3, ndf=64,
                                     norm=NormConfig(kind="instance", affine=True))
    netD = NLayerDiscriminator(dcfg, generator=torch.Generator().manual_seed(5))
    ckpt.save_net(os.path.join(root, "teacher"), "best_A", "D_A", netD.state_dict(), dcfg)


class _TimedLoader:
    """A loader whose every batch fetch is timed on the host clock."""

    def __init__(self, loader, waits):
        self.loader, self.waits = loader, waits

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


def run_verb(root, label, extra, expect_path, dev, card):
    """``entry.distill_main`` with the recipe's flags and ``extra``; checks
    launches, checkpoints, reload and losses, and returns the run's numbers
    and the distill run."""
    import numpy as np
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    log_dir = os.path.join(root, f"log_{label}")
    teacher = os.path.join(root, "teacher")
    argv = ["--dataroot", os.path.join(root, "data"), "--log_dir", log_dir,
            "--restore_teacher_G_path", os.path.join(teacher, "best_A_net_G_A.pth"),
            "--restore_pretrained_G_path", os.path.join(teacher, "best_A_net_G_A.pth"),
            "--restore_D_path", os.path.join(teacher, "best_A_net_D_A.pth"),
            *RECIPE, *extra]
    steps, starts, waits = [], [], []
    setup = entry.setup_distill

    def instrumented(opt, device=None, loader=None):
        run = setup(opt, device, loader)
        step_fn = run.trainer.step_fn

        def timed_step(state, batch, lr):
            t0 = time.perf_counter()
            out = step_fn(state, batch, lr)
            torch.cuda.synchronize()
            starts.append(t0)
            steps.append(time.perf_counter() - t0)
            return out

        run.trainer.step_fn = timed_step
        run.trainer.dataloader = _TimedLoader(run.trainer.dataloader, waits)
        return run

    n_steps = VERB_EPOCHS * VERB_IMAGES // VERB_BATCH
    entry.setup_distill = instrumented
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ka.launches = 0
        ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
        t0 = time.perf_counter()
        run = entry.distill_main(argv)
        wall = time.perf_counter() - t0
        launches, on_path = ka.launches, ka.path_launches[expect_path]
    finally:
        entry.setup_distill = setup
    mem = torch.cuda.max_memory_allocated()
    if len(steps) != n_steps or launches != 8 * n_steps or on_path != launches:
        fail(f"verb ({label}): {len(steps)} steps, {launches} Gram launches, {on_path} of them "
             f"the {expect_path!r} kernel; expected {n_steps} steps and 8 launches per step, all "
             f"{expect_path!r}")

    save_dir = os.path.join(log_dir, "checkpoints")
    for name in ("latest_net_G.pth", "latest_net_G.json", f"{VERB_EPOCHS}_net_G.pth",
                 "latest_state.pth"):
        if not os.path.exists(os.path.join(save_dir, name)):
            fail(f"verb ({label}): {name} was not written")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [v for r in rows for k, v in r.items() if "loss" in k]
    if len(rows) != n_steps or not all(math.isfinite(v) for v in losses):
        fail(f"verb ({label}): {len(rows)} logged steps, losses finite: "
             f"{all(math.isfinite(v) for v in losses)}")

    # the saved student reproduces the in-memory one exactly
    batch = next(iter(run.loader))
    x = batch["A"].to(dev)
    sd, cfg = ckpt.load_net(save_dir, "latest", "G")
    gen = InceptionGenerator(cfg, packed_blocks=run.distiller.hp.packed_blocks).to(dev)
    gen.load_state_dict(sd)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            same = torch.equal(gen(x[:4]), run.distiller.generate_student(run.state, x[:4]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not same:
        fail(f"verb ({label}): the reloaded student's output differs from the in-memory one")

    step_ms = 1e3 * float(np.median(steps[1:]))
    # from one step's start to the next: the step, the loader wait, logging
    iter_ms = 1e3 * float(np.median(np.diff(starts)))
    out = {"label": label, "steps": len(steps), "step_ms_median": step_ms,
           "step_ms": [round(1e3 * t, 1) for t in steps],
           "images_per_s": VERB_BATCH / (step_ms / 1e3), "iteration_ms_median": iter_ms,
           "images_per_s_with_loader": VERB_BATCH / (iter_ms / 1e3),
           "loader_wait_ms_per_step": 1e3 * sum(waits[1:]) / max(len(waits) - 1, 1),
           "loader_wait_ms_first": 1e3 * waits[0], "wall_s": wall,
           "peak_memory_gib": mem / 2 ** 30, "gram_launches": launches,
           "gram_path": expect_path, "last_losses": {k: v for k, v in rows[-1].items()
                                                    if "loss" in k}}
    log(f"verb ({label}): median step {step_ms:.1f} ms over steps 2-{len(steps)}, "
        f"{out['images_per_s']:.1f} images/s; median iteration {iter_ms:.1f} ms, "
        f"{out['images_per_s_with_loader']:.1f} images/s; host wait on the loader "
        f"{out['loader_wait_ms_per_step']:.1f} ms per step (first fetch "
        f"{out['loader_wait_ms_first']:.0f} ms), peak memory {out['peak_memory_gib']:.2f} GiB, "
        f"{launches} Gram launches ({expect_path}), fit {wall:.1f} s, steps {out['step_ms']} "
        f"[{card}]")
    return out, run, x


def distill_verb(dev, card, teacher_cfg, teacher_sd):
    """Phase 6: the recipe through ``entry.distill_main``, (a) float32 with
    the host loader and (b) bfloat16 with the device bank; the Gram kernel
    held against its plain version on each run's own (80, F) taps."""
    import shutil
    import tempfile

    import torch

    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    root = tempfile.mkdtemp(prefix="chip_smoke_verb_")
    try:
        t0 = time.perf_counter()
        write_verb_inputs(root, teacher_cfg, teacher_sd)
        log(f"verb: dataset ({VERB_IMAGES} + 2 PNGs per side, {SIZE} px) and checkpoints "
            f"written in {time.perf_counter() - t0:.1f} s")
        results, kern = [], {}
        for label, extra, dtype, path in (
                ("a", [], torch.float32, "f32tma"),
                ("b", ["--compute_dtype", "bfloat16", "--on_device_data", "1"],
                 torch.bfloat16, "tma")):
            out, run, x = run_verb(root, label, extra, path, dev, card)
            with torch.no_grad():
                taps = [net(x, taps=("encode",))[1]["encode"].reshape(x.shape[0], -1)
                        .to(dtype).contiguous()
                        for net in (run.distiller.netG_teacher, run.distiller.netG_student)]
            kern[label] = gram_numbers(taps, flush, card, path)
            results.append(out)
            del run, taps
        return results, kern
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del l2


_KERNEL_GROUPS = (  # (group, substrings of the lower-cased kernel name), first match wins
    ("gram (csrc/gram.cu)", ("gram_partial", "gram_reduce")),
    ("instance_norm_act (csrc/instance_norm.cu)", ("inorm_act",)),
    ("cuDNN NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
    ("convolution / matmul", ("conv", "gemm", "xmma", "sm90_", "sm80_", "cutlass", "cudnn",
                              "dgrad", "wgrad")),
    ("reflection pad", ("reflection_pad",)),
    ("multi-tensor (Adam)", ("multi_tensor", "foreach")),
    ("reduction (plain norm statistics, losses)", ("reduce",)),
    ("elementwise / copy / cast", ("elementwise", "copy", "cat", "fill")),
)


def profile(step, n, card):
    """Device time of ``n`` steps by kernel group, from torch.profiler;
    returns the device-busy milliseconds per step (None if the profiler saw
    no device time).  The profiler slows the host, so its wall time is no
    measure of the idle share."""
    import torch

    from cat_tpu_torch import import_stdlib_profile

    import_stdlib_profile()  # the repository root's profile.py would shadow it
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log("profile: torch.profiler saw no device time on this machine")
        return None
    groups = {}
    for e in kernels:
        name = e.key.lower()
        g = next((g for g, keys in _KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    log(f"profile over {n} flagship steps [{card}]: device busy {busy_us / 1e3 / n:.1f} "
        f"ms/step ({wall_us / 1e3 / n:.1f} ms/step wall with the profiler on)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {g:45s} {us / 1e3 / n:9.2f} ms/step  {100 * us / busy_us:5.1f}%")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms/step  x{e.count // n:<4d} {e.key[:90]}")
    return busy_us / 1e3 / n


def main() -> None:
    try:
        import torch

        import cat_tpu_torch  # noqa: F401
        from cat_tpu_torch.utils import cuda_build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of the repository")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs an NVIDIA GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # --- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # --- 2. kernels
    t0 = time.perf_counter()
    cuda_build.build_all(["gram", "instance_norm"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")
    for name in ("gram", "instance_norm"):
        with open(f"{cuda_build._lib_path(name)}.log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    teacher_cfg, teacher_sd, res = flagship()
    kern = check_kernels(dev, teacher_cfg.ds_channels, res.config.ds_channels, card)

    # --- 3. a small step against the CPU
    reference_check(dev)

    # --- 4. the flagship step
    log(f"flagship step at batch {BATCH} (as bench.py), {SIZE} px, bf16, packed blocks")
    times, counts, vals, mem, busy_ms = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                  False, 1 + TIMED_STEPS, card,
                                                  profile_steps=2)
    if counts["gram"] != 8 * (1 + TIMED_STEPS) or counts["gram_tma"] != counts["gram"]:
        fail(f"Gram kernels launched {counts['gram']} times in {1 + TIMED_STEPS} steps, "
             f"{counts['gram_tma']} of them the TMA kernel; expected 8 per step, all TMA")
    step_s = sum(times[1:]) / TIMED_STEPS
    log(f"flagship: {step_s * 1e3:.1f} ms/step, {BATCH / step_s:.1f} images/s "
        f"(warm-up step {times[0] * 1e3:.0f} ms), student {res.searched_macs} MACs, "
        f"peak memory {mem / 2**30:.2f} GiB, launches {counts}, losses {vals} [{card}]")
    if busy_ms is not None:
        log(f"flagship: device idle {100 * max(0.0, 1 - busy_ms / (step_s * 1e3)):.1f}% "
            "(profiled device-busy time per step against the unprofiled step time)")
    gram_launches = counts["gram"]

    # --- 5. the fused-norm step
    times_f, counts_f, vals_f, _, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                True, FUSED_STEPS, card)
    if (counts_f["instance_norm_act"] != 6 * FUSED_STEPS or counts_f["gram"] != 8 * FUSED_STEPS
            or counts_f["gram_tma"] != counts_f["gram"]):
        fail(f"fused step: launches {counts_f}, expected 6 norm and 8 Gram (TMA) per step")
    log(f"fused-norm step: {sum(times_f) / FUSED_STEPS * 1e3:.1f} ms/step (first step "
        f"included), launches {counts_f}, losses {vals_f} [{card}]")

    # --- 6. the distill verb
    verb, verb_kern = distill_verb(dev, card, teacher_cfg, teacher_sd)
    log("verb: " + json.dumps(verb))

    def row(name, src, replaces, launches, k, per):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
                "library_ms": k["library_ms"], "per": per}

    gram_src = ("cat_tpu_torch/csrc/gram.cu", "cat_tpu/distill/ka.py:51")
    per = f"one training step's launches at batch {BATCH}, bf16"
    rows = [
        {**row("gram", *gram_src, gram_launches, kern[("gram", "bfloat16")], per),
         "mma_sync_ms": kern[("gram", "bfloat16")]["mma_sync_ms"],
         "bound_full_square_ms": kern[("gram", "bfloat16")]["bound_full_square_ms"]},
        row("instance_norm_act", "cat_tpu_torch/csrc/instance_norm.cu",
            "cat_tpu/ops/pallas_norm.py:35", counts_f["instance_norm_act"],
            kern[("instance_norm_act", "bfloat16")], per),
    ]
    for v, dname in zip(verb, ("float32", "bfloat16")):
        k = verb_kern[v["label"]]
        rows.append({**row(f"gram (distill verb, {dname})", *gram_src, v["gram_launches"], k,
                           f"one training step's launches at batch {VERB_BATCH}, {dname}, on "
                           f"the run's own taps ({v['gram_path']} kernel)"),
                     **{key: k[key] for key in ("fma_ms", "bound_full_square_ms") if key in k}})
    # the f32 kernel at phase 2's batch 128 (launches: its count in phase 6 (a))
    f32 = kern[("gram", "float32")]
    rows.append({**row("gram (float32, batch 128)", *gram_src, verb[0]["gram_launches"], f32,
                       f"four taps' launches at batch {BATCH}, float32 (phase 2's operands; "
                       f"launches are the f32tma kernel's in phase 6 (a))"),
                 "fma_ms": f32["fma_ms"], "bound_full_square_ms": f32["bound_full_square_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
