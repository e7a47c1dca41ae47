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
     shapes and the latter also at an F % 4 != 0 shape.  Past 128 rows, the
     pair kernels of both dtypes (one launch over all pairs of 128-row
     blocks): at B = 256 on the teacher's and the student's tap, checked
     (one launch, G == Gᵀ exactly, two calls bit-identical, the plain
     version's result), the teacher's timed; at B = 300 (a ragged last
     block) in place and on a padded copy (F % 8 != 0), checked only.  The
     instance norm at the six trunk sites of both nets (batch 128, bf16
     and f32): the forward on its planned path (one CTA or a cluster; relu,
     leaky relu and none) and forced onto the two-pass loop, and the
     backward kernel against its plain twin (relu and none; two calls
     bit-identical), timed beside their bounds, the plain versions and
     ``F.instance_norm``'s forward and backward; then at every site the
     flagship step fuses (``models/generator.py::fused_norm_sites``: trunk,
     packed blocks' kernel-size groups and depthwise stage, ``pw_bn`` with
     no activation, upsampling; batch 128, bf16), each distinct shape's
     forward and backward kernel against the plain versions with the site's
     activation, timed beside the plain versions and the bound, with one
     step's totals by layer; a 255² plane checks the two-pass path both ways.
     ADM's GroupNorm chain (``csrc/group_norm.cu``) at every site shape of
     its cell's step (``group_norm_site_numbers``: teacher forward, student
     forward and backward, batch 16, 256 px, bf16): each shape checked
     against the plain twin (y, dx, dγ, dβ and the scale-shift's gradient
     within tolerance), then timed beside the bytes bound, the twin and
     ATen's ``F.group_norm`` + ``addcmul`` + ``F.silu`` on bf16, in the
     channels-last UNet's layouts on the NHWC kernels and beside the NCHW
     kernels at the same sites; one step's totals; then two steps of the
     ADM cell's program (batch 16, bf16) launch the forward once a site of
     both nets and the backward once a student site, all on the NHWC
     kernels, by the counters, and a profiled step runs no cuDNN
     transpose;
  3. reference: one float32 KA-distillation step at a tiny size on the card
     (kernels) and on the CPU (plain versions), losses compared, at batch 2
     and at batch 130 (4 launches of the float32 pair kernel; the norm
     kernel's forward once per instance norm of both nets and its backward
     once per student norm, ``fused_norm_sites``, its blocks unpacked);
  4. flagship: the horse2zebra KA-distillation step of ``bench.py`` (teacher
     ngf 64 / r6 / kernels 1,3,5; student shrunk to 2.6e9 MACs; 256 px;
     unaligned lsgan + KA over encode, block2, block5, block8; bf16 compute,
     float32 masters; packed blocks) at full width: 1 warm-up + 3 timed steps,
     the Gram's TMA kernel launched 8 times per step; 4b: the same step at
     batch 256, 1 warm-up + 1 timed step, the bf16 pair kernel launched 8
     times per step; 4c: 4b in float32 (TF32 off), the float32 pair kernel
     launched 8 times per step;
  5. fused norms: the same step with ``fused_norms=True``, 1 warm-up + 3
     timed steps, their median beside phase 4's; the norm kernel launched
     once per instance norm of both nets and its backward once per student
     norm (``fused_norm_sites``: trunk, packed blocks, ``pw_bn``, upsampling);
  6. distill verb: ``entry.distill_main`` with the flags of
     ``scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh`` (batch
     80, 2.6e9-MAC student, KA, lsgan, pretrained-G transfer and D restore)
     over a seeded unaligned dataset of 256x256 PNGs (160 per training side,
     120 in valA and 140 in valB, horse2zebra's test split), 4 steps (8
     before phase 14), three
     times: (a) float32 with the host loader, (b) bfloat16 with the
     device-resident bank, (c) float32 with ``--data_backend native`` (the
     C++ image pipeline), timed for its loader wait beside (a).  The Gram
     kernel must launch 8 times per step (the f32 TMA + FMA kernel in (a) and
     (c), the bf16 TMA kernel in (b)) and is held against its plain version
     on the run's own (80, F) taps (in (a) also for bit-identity and
     symmetry, and timed beside the old FMA kernel); the checkpoints must
     exist and reload to the in-memory student's output exactly.  A line
     says whether the C++ pipeline built; when it did, (b)'s bank (filled by
     it) is held against PIL's resize within the JAX package's bounds (max
     3/255, mean under 1);
  7. evaluation: a seeded random judge; ``real_stat_main`` over valB; a
     2-step bf16 distill run with the bank, ``--inception_path`` and
     ``--real_stat_path``, which must log ``metric/fid`` and save ``best``;
     ``profile_main`` on its best student (every val image dumped) and
     ``kid_score_main`` on that dump; the judge's pool3 features on the card
     against the CPU's for 4 images.  Prints the statistics' images/s, the
     evaluations' seconds split into generator sweep, judge and Fréchet
     distance on the host, and the profile's prune time, latency and peak
     memory;
  8. teacher training: (a) two tiny float32 steps of pix2pix with tracked
     batch norm, pix2pix under wgangp (the penalty's α fixed on both sides)
     and CycleGAN, on the card and on the CPU, losses and running
     statistics compared; (b) ``entry.train_main`` with
     ``scripts/cycle_gan/horse2zebra/train_inception_teacher.sh``'s flags
     (batch 32) over phase 6's unaligned PNGs for 1 epoch (5 steps), fid_B
     against phase 7's statistics (with ``--remat 1`` where batch 32 does not
     fit the card without it, said on a line): the pools hold 50 after step
     2, G_A, G_B, D_A, D_B and the state are written, the reloaded G_A gives
     the in-memory G_A's output exactly; (c) the same with
     ``scripts/pix2pix/map2sat/train_inception_teacher.sh``'s flags (tracked
     batch norm, BtoA) over 160 seeded aligned 512x256 PNGs and 40 val: the
     running statistics moved from (0, 1), the reloaded G gives the eval-mode
     output exactly; both print the median step and iteration, images/s,
     the loader wait, peak memory and the evaluations' seconds; (d)
     ``entry.distill_main`` with the horse2zebra student recipe for 2 steps
     from (b)'s G_A and D_A, 8 Gram launches a step;
  9. Cityscapes: (a) a reduced DRN judge and ``get_miou`` at 64x128 on the
     card against the CPU (the same argmax everywhere), and two tiny float32
     SPADE teacher steps (ngf 16, 64x32, batch 2, VGG, spectral multiscale D)
     on the card and on the CPU, each from the card's state: losses, the
     parameters each step writes (within Adam's one-step bound), running
     statistics and spectral ``u``; (b) the pix2pix Cityscapes recipes with
     mIoU (a full-spec DRN-D-105 with seeded weights in the reference .pth
     layout at 2048x1024, trainId maps and a table under a cityscapes-origin
     tree) and FID (phase 7's judge and statistics) over 80 + 10 seeded
     aligned 512x256 PNGs: the teacher recipe for 4 steps at batch 32, the
     5.6e9-MAC student recipe from its best G and D for 2 steps at batch 80
     (8 float32 Gram launches a step, the kernel held against its plain
     version on the run's own taps; mIoU alone), the evaluate recipe's
     profile; (c) the GauGAN teacher recipe at full width (ngf 64, 512x256,
     batch 16, 35 labels + dontcare + edges, VGG with seeded torchvision-layout
     weights, xavier, float32) over 48 + 10 seeded samples in Cityscapes'
     layout (2048x1024 photos) for 9 steps with FID and mIoU (with
     ``--remat 1`` where batch 16 does not fit, said on a line), and the
     eval-mode output's spread and movement at each evaluation.  The SPADE
     runs of phases 9 and 10 evaluate their branches packed, the recipes'
     default.  Each run
     prints its median step and iteration, loader wait and peak memory, and
     its evaluations' seconds split into generator sweeps, FID judge, host
     ``sqrtm``, DRN judge and histograms;
 10. GauGAN distillation: (a) two tiny float32 SPADE distill steps (teacher
     ngf 16, student ngf 8, 64x32, batch 2, KA on head_0, G_middle_1 and
     up_1, VGG, spectral multiscale D) on the card and on the CPU, each from
     the card's state: losses with the three distill parts, parameters
     within twice Adam's one-step bound, running statistics and ``u``, 6
     ``f32tma`` Gram launches a step; (b) ``entry.distill_main`` with
     ``scripts/gaugan/cityscapes/train_inception_student_5p6B.sh``'s flags
     at full width (batch 16, 512x256, 9c's latest G as teacher and
     pretrained G, 9c's D, 5.6e9 MACs, xavier, float32) over 9c's data for
     2 epochs of 3 steps with FID and mIoU at the startup probe and at the
     end (``--remat 1`` where batch 16 does not fit, said on a line): 6
     ``f32tma`` Gram launches a step, the searched MACs within the budget,
     the checkpoints, the reloaded G's eval output exact, and the Gram held
     against its plain version and timed on the run's own six taps at
     B = 16; (b) again with ``--packed_blocks 0`` and no evaluations, its
     median step beside the packed one's; (d) the recipe's first epoch (3
     steps, no evaluations, deterministic cuDNN) without ``--remat``, then
     with ``--remat 1``, without and with ``--remat_policy dots_saveable``:
     median step, peak memory, 6 ``f32tma`` launches a step, each remat
     run's losses within 10a's bound of the run without's (10b's own gap
     to that run, under cuDNN's default algorithms, printed); (c) the
     profile verb with ``evaluate_inception_student_5p6B.sh``'s flags on (b)'s
     best student, and ``--prune_only`` at 3e10 MACs;
 11. export: the export verb with the flags of
     ``scripts/cycle_gan/horse2zebra/export_inception_student_2p6B.sh`` on
     phase 6 (a)'s student and of
     ``scripts/gaugan/cityscapes/export_inception_student_5p6B.sh`` on 10b's
     best (``--export_format stablehlo`` as shipped: a ``.pt2``); each program
     loaded on the card and run at batch 1 and 4 against the eager eval-mode
     student (rtol 1e-4, atol 1e-5 of its largest value), its batch-1
     latency beside the profile verb's for the same student, its size, the
     export's seconds and peak memory;
 12. data parallelism (float32, TF32 off): (a) phase 6's recipe for 4 steps
     in one process, twice, and in an NCCL group of one rank on cuda:0 that
     the verb joins, with deterministic cuDNN: step 1's losses within 1e-6
     relative, every step's within phase 10d's bound, 8 f32tma Gram
     launches a step on 80 rows and 8 row gathers a step; (b) the same
     recipe at global batch 80 over two gloo ranks that share cuda:0
     (NCCL refuses two ranks on one card), 40 rows each: losses within
     DP_LOSS_TOL of max(|loss|, 0.1) of (a)'s one-process run, 8 Gram
     launches a step on the 80 gathered rows on both ranks, each rank's
     step, its row gathers timed alone and its peak memory (two ranks on
     one card: not a scaling number); (c) 10b's recipe for one epoch (3
     steps, global batch 16) in one process and over the two ranks, its
     losses within the same bound, then one FID + mIoU evaluation of the
     one-process student over one and over two ranks: FID within 1e-3
     relative, the confusion matrix exactly; then which collectives gloo
     serves for CUDA tensors;
 13. spatial parallelism (``--n_spatial``: image height split over ranks;
     float32, TF32 off): (a) two tiny float32 steps each of the KA
     distiller, pix2pix (tracked batch norm, wgangp with fixed α) and
     CycleGAN in one process on the card, then over two gloo ranks sharing
     cuda:0 (1 x 2) and over four (2 x 2), step 2 from the one-process
     state after step 1: losses within DP_LOSS_TOL of max(|loss|, 0.1), 4
     Gram launches a step on each rank; at 1 x 2 also the distiller under
     ``--fused_norms``: each split-plane entry point of the norm kernel
     launched once a step for each instance norm of both nets
     (``fused_norm_sites``), the whole-plane kernel never; (b)
     ``entry.distill_main`` with phase 6's recipe and ``--n_spatial 2`` over
     two ranks on cuda:0 for 4 steps: step 1's losses within DP_LOSS_TOL of
     phase 12 (a)'s one process (later steps' gaps printed), 8 f32tma Gram
     launches a step on each rank on (80, F/2) operands, each rank's median
     step, its halo exchanges of a step replayed alone (count, bytes,
     time) and its peak memory, then the Gram held against its plain
     version and timed on the run's own half-height taps; (c) the norm
     kernel's split entry points against their plain versions at the
     flagship's ConvNormAct shapes cut in two heights, bf16 and float32,
     timed beside their bounds; (a) also takes the 1 x 2 distiller's step-1
     gap apart: D's per-layer outputs over the split height against one
     process's, D's parameters after step 1 (how many differ by more than
     0.5·lr: Adam's first step is lr·sign(g)) and the two updated Ds'
     per-layer outputs; (e) the GauGAN family: two tiny float32 steps each
     of the SPADE teacher task and the SPADE distiller with KA, with
     ``mse``, under wgangp (fixed α) and under ``--remat 1`` (10a's sizes,
     a 1-row latent that the second spatial rank does not own), in one
     process and over 1 x 2 and 2 x 2 gloo ranks on cuda:0: losses within
     DP_LOSS_TOL, D's ``u`` alike on every rank, 6 Gram launches a step on
     the ranks that own the latent and 4 on the others (their head_0
     operands have no columns); (d) the 5p6B GauGAN student recipe (10b's
     flags, 9c's teacher and D) with ``--n_spatial 2`` over two ranks on
     cuda:0 for its first epoch (3 steps at batch 16): step 1's losses
     within DP_LOSS_TOL of phase 12 (c)'s one process (later steps' gaps
     printed), 6 f32tma Gram launches a step on each rank on (16, F/2)
     operands, each rank's median step, halo exchanges of a step replayed
     alone and peak memory, the Gram held against its plain version and
     timed on the run's own six half-height taps, then one FID + mIoU
     evaluation of its student over the two ranks against one process's
     (FID within 1e-3 relative, the confusion matrix exactly).  Two or
     four ranks on one card measure the path, not scaling;
 14. the int8 teacher, the UNet, DeepLab v2: (a) every distinct conv of the
     flagship teacher (stem, down, pointwise, packed, depthwise, transposed,
     head) at batch 80 in bf16 on seeded inputs: the card's int32
     accumulator (im2col + ``torch._int_mm`` for groups 1,
     ``csrc/int8_conv.cu`` otherwise) equal to the float64 plain version
     bit for bit, the dequantised output equal to the plain one; times of
     the quantisation, the accumulator, the dequantisation, the whole
     int8 conv, the plain version and cuDNN's bf16 conv, beside the bound
     (2·MACs at the dense int8 peak, or the bytes); (b) phase 6 (b)'s run
     with ``--teacher_compute_dtype int8`` and ``int8_static``, 4 steps
     each: 8 bf16 Gram launches a step, both int8 paths launched, the step
     beside 6 (b)'s, the teacher's taps against the bf16 teacher's on the
     same batch, one calibrated scale per teacher conv, the Gram held
     against its plain version on the int8 run's taps; (c) 10b's GauGAN
     student recipe with ``int8_static`` for 3 steps: step, peak memory, 6
     f32tma Gram launches a step; (d) ``GenericDistiller`` at
     ``tools/bench_unet_distill.py``'s configuration (UNet base 64 -> 32,
     256 px, batch 32, bf16, KA on down1, mid, up1): 1 + 3 steps, peak
     memory, 6 Gram launches a step, the Gram on the run's own taps; (e)
     DeepLabV2 in ResNet-101 DeepLab v2's layout (182 classes) under MSC on
     one 513 x 513 image, card against CPU within 1e-4 of the largest
     logit, and its milliseconds an image.

The script prints its total seconds.
The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 128  # bench.py's batch
SIZE = 256
TIMED_STEPS = 3
LR = 2e-4
VERB_BATCH = 80  # the student recipe's batch
VERB_IMAGES = 160  # per side: 2 steps per epoch
VERB_EPOCHS = 2  # phase 6: 4 steps a run (8 before phase 14 took the time)
VAL_IMAGES = {"valA": 120, "valB": 140}  # horse2zebra's test split
PAIRS_BATCH = 256  # a batch past 128 rows: the pair kernels' (phases 2, 4b and 4c)
PAIRS_STEPS = 2  # phases 4b and 4c: 1 warm-up + 1 timed step
REF_PAIRS_BATCH = 130  # phase 3's second tiny float32 step
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


def gram_numbers(xs, flush, card, expect_path: str, compare_mma: bool = False,
                 names=("teacher", "student"), per_step: int = 4):
    """Hold the Gram kernel against its plain version on each (B, F)
    operand of ``xs`` (by default a teacher and a student tap), which must
    take kernel ``expect_path``, and time kernel, plain version, one-call
    PyTorch yardstick and bound; returns the totals of one step (each
    operand's numbers ``per_step`` times: by default four taps, so four
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
    for who, x in zip(names, xs):
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
            tot[k] += per_step * v
        tot["err"] = max(tot["err"], err)
    return tot


def gram_pairs_numbers(x, flush, card, time_it=True):
    """The Gram of a (B, F) operand, B > 128, through the pair kernel of its
    dtype: one launch, the plain version's result (``gram_pairs_plain``)
    within 1e-5 of the largest entry, G == Gᵀ exactly, two calls
    bit-identical; with ``time_it``, kernel, plain, library and bound times
    per call."""
    import torch

    from cat_tpu_torch.distill import ka

    b, f = x.shape
    dname = str(x.dtype).split(".")[-1]
    path = "f32tma_pairs" if x.dtype == torch.float32 else "tma_pairs"
    if ka._gram_path(b, f, x.dtype, x.data_ptr() % 16 == 0) != path:
        fail(f"gram {dname} B = {b}: the {path!r} kernel was not selected")
    copy = ka._pair_copy_width(f, x.dtype, x.data_ptr() % 16 == 0)
    before, on_path = ka.launches, ka.path_launches[path]
    got = ka.gram_cuda(x)
    torch.cuda.synchronize()
    launches = ka.launches - before
    if launches != 1 or ka.path_launches[path] - on_path != 1:
        fail(f"gram {dname} B = {b}: {launches} launches, expected one of {path!r}")
    if not torch.equal(got, got.T):
        fail(f"gram {dname} B = {b}: the {path} result is not exactly symmetric")
    if not torch.equal(got, ka.gram_cuda(x)):
        fail(f"gram {dname} B = {b}: two calls of the {path} kernel differ")
    err = _check_gram(got, ka.gram_pairs_plain(x), f"{dname} {path} B = {b} F = {f}")
    del got
    where = "in place" if copy is None else f"a zero-padded copy of width {copy}"
    if not time_it:
        log(f"gram {path} {dname} B={b} F={f} ({where}): one launch, max|err| {err:.3g}, "
            f"G == Gᵀ exactly, two calls bit-identical")
        return None
    if x.dtype == torch.float32:
        lib_name, library = "torch.matmul(x, x.T)", lambda: torch.matmul(x, x.T)
    else:
        lib_name = "torch.mm(x, x.T, out_dtype=float32)"
        library = lambda: torch.mm(x, x.T, out_dtype=torch.float32)  # noqa: E731
    # in turns, kernel first and last
    ms = timed(lambda: ka.gram_cuda(x), flush=flush)
    lib = timed(library, flush=flush)
    plain = timed(lambda: ka.gram_pairs_plain(x), flush=flush, iters=5)
    ms2 = timed(lambda: ka.gram_cuda(x), flush=flush)
    bytes_ms = 1e3 * (b * f * x.element_size() + b * b * 4) / HBM_BYTES_PER_S
    ops_ms = 1e3 * b * (b + 1) * f / PEAK_FLOPS[dname]
    bound = max(bytes_ms, ops_ms)
    log(f"gram {path} {dname:8s} B={b} F={f} ({where}): kernel {ms:.4f}, {ms2:.4f} ms "
        f"({100 * bound / ms:.1f}% of bound), plain {plain:.4f} ms, {lib_name} {lib:.4f} ms, "
        f"bound {bound:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'ops'}), max|err| "
        f"{err:.3g}, one launch, G == Gᵀ exactly, two calls bit-identical [{card}]")
    return {"b": b, "f": f, "launches_per_call": launches, "ms": ms, "ms_again": ms2,
            "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "err": err}


def _norm_tol(dtype):
    """f32: statistics summed in another order; bf16: one unit in the last
    place (relative 2^-7)."""
    import torch

    return (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)


def _check_close(got, ref, what):
    """Max |got - ref|; fails beyond the dtype's rtol plus atol."""
    import torch

    torch.cuda.synchronize()
    rtol, atol = _norm_tol(ref.dtype)
    diff = (got.float() - ref.float()).abs()
    excess = float((diff - rtol * ref.float().abs()).max())
    if not excess <= atol or not torch.isfinite(got).all():
        fail(f"{what}: error beyond rtol {rtol:g} by {excess:g} > {atol:g}")
    return float(diff.max())


def _check_norm(x, scale, bias, act, path, plan=None):
    """The forward kernel on ``plan`` (default: its own) against the plain
    version; returns max |err|."""
    from cat_tpu_torch.ops import instance_norm as inorm

    got = inorm.forward_cuda(x, scale, bias, 1e-5, act, plan)[0]
    ref = inorm.instance_norm_act_plain(x, scale, bias, 1e-5, act)
    return _check_close(got, ref, f"instance_norm_act {act} {path} {x.dtype} {tuple(x.shape)}")


def _check_norm_bwd(x, g, scale, bias, path, plan=None, act="relu"):
    """The backward kernel (activation ``act``) against its plain twin, both
    on the forward kernel's mean and rstd (relu's mask flips where z is
    within a rounding of 0, so the twin takes the same statistics): dx within the
    forward's tolerance; dscale and dbias, sums of N·H·W float32 terms in
    another order, within 1e-5 of the sum of the terms' magnitudes; two
    calls bit-identical.  Returns (max |err| of dx, the outputs)."""
    import torch

    from cat_tpu_torch.ops import instance_norm as inorm

    _, mean, rstd = inorm.forward_cuda(x, scale, bias)
    got = inorm.instance_norm_act_backward_cuda(x, g, mean, rstd, scale, bias, act, plan)
    again = inorm.instance_norm_act_backward_cuda(x, g, mean, rstd, scale, bias, act, plan)
    ref = inorm.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act, (mean, rstd))
    what = f"instance_norm_act backward {act} {path} {x.dtype} {tuple(x.shape)}"
    err = _check_close(got[0], ref[0], what + " dx")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{what}: two calls differ")
    xh = (x.float() - mean.reshape(*x.shape[:2], 1, 1)) * rstd.reshape(*x.shape[:2], 1, 1)
    gp = g.float() * inorm._act_grad(xh * scale[:, None, None] + bias[:, None, None], act)
    for name, k, terms in (("dscale", 1, gp * xh), ("dbias", 2, gp)):
        tol = 1e-5 * terms.abs().sum(dim=(0, 2, 3)) + 1e-6
        gap = (got[k] - ref[k]).abs()
        if not bool((gap <= tol).all()):
            fail(f"{what} {name}: max |err| {float(gap.max()):g}, beyond 1e-5 of the terms' "
                 f"magnitudes")
    del xh, gp
    return err, got


def norm_numbers(planes, dtype, gen, flush, card):
    """The forward kernel at each (C, H = W) of ``planes`` (batch BATCH),
    relu, leaky relu and none, on its planned path against the plain version,
    and relu on the two-pass loop too; times kernel, two-pass loop, plain
    version, ``F.instance_norm`` (norm + affine, no ReLU: less work) and the
    bound (one read and one write); returns the totals of one step (each
    site once)."""
    import torch

    from cat_tpu_torch.ops import instance_norm as inorm

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    tot = {"ms": 0.0, "two_pass_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "err": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "paths": {}}
    for c, hw in planes:
        x = (torch.randn(BATCH, c, hw, hw, generator=gen, device=dev) * 3 + 1).to(dtype)
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.randn(c, generator=gen, device=dev)
        plan = inorm.norm_plan(hw * hw, x.element_size())
        err = max(_check_norm(x, scale, bias, act, plan.path)
                  for act in ("relu", "leaky_relu", "none"))
        err2 = _check_norm(x, scale, bias, "relu", "two_pass", inorm.TWO_PASS)
        # in turns: kernel, two-pass, plain, library
        ms = timed(lambda: inorm.forward_cuda(x, scale, bias), flush=flush)
        two = timed(lambda: inorm.forward_cuda(x, scale, bias, plan=inorm.TWO_PASS), flush=flush)
        plain = timed(lambda: inorm.instance_norm_act_plain(x, scale, bias), flush=flush)
        lib = timed(lambda: torch.nn.functional.instance_norm(x, weight=scale, bias=bias,
                                                              eps=1e-5), flush=flush)
        # one read and one write; ~10 flops per element on CUDA cores
        bytes_ms = 1e3 * 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
        ops_ms = 1e3 * 10 * x.numel() / PEAK_FLOPS["float32"]
        bound = max(bytes_ms, ops_ms)
        where = f"{plan.path} k={plan.k} ppc={plan.ppc}"
        log(f"instance_norm_act {dname:8s} {tuple(x.shape)} ({where}): kernel {ms:.4f} ms "
            f"({100 * bound / ms:.1f}% of bound), two-pass loop {two:.4f} ms, plain "
            f"{plain:.4f} ms, F.instance_norm (norm + affine, no ReLU) {lib:.4f} ms, bound "
            f"{bound:.4f} ms, max|err| {err:.3g} (two-pass {err2:.3g}; tol rtol "
            f"{_norm_tol(dtype)[0]:g} + atol {_norm_tol(dtype)[1]:g}) [{card}]")
        for k, v in (("ms", ms), ("two_pass_ms", two), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
        tot["paths"][f"{c}x{hw}x{hw}"] = {"path": where, "ms": ms, "two_pass_ms": two,
                                          "library_ms": lib, "bound_ms": bound}
        del x
    log(f"instance_norm_act {dname}, six sites: kernel {tot['ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of bound), two-pass loop "
        f"{tot['two_pass_ms']:.4f} ms, F.instance_norm {tot['library_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms [{card}]")
    return tot


def norm_bwd_numbers(planes, dtype, gen, flush, card):
    """The backward kernel at each (C, H = W) of ``planes`` (batch BATCH)
    on its planned path against its plain twin, relu and none, bit-identical
    over two calls; times (relu) kernel, twin, the backward of ``F.instance_norm(x,
    weight=γ, bias=β)`` alone (its graph built outside the timed region:
    norm + affine without the ReLU mask) and the bound (x and g read once,
    dx written once); returns the totals of one step (each site once)."""
    import torch

    from cat_tpu_torch.ops import instance_norm as inorm

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "bytes_ms": 0.0, "ops_ms": 0.0, "paths": {}}
    for c, hw in planes:
        x = (torch.randn(BATCH, c, hw, hw, generator=gen, device=dev) * 3 + 1).to(dtype)
        g = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.randn(c, generator=gen, device=dev)
        plan = inorm.norm_plan(hw * hw, x.element_size(), 2)
        err = max(_check_norm_bwd(x, g, scale, bias, plan.path, act=act)[0]
                  for act in ("relu", "none"))
        _, mean, rstd = inorm.forward_cuda(x, scale, bias)
        xl = x.detach().requires_grad_(True)
        wl, bl = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        yl = torch.nn.functional.instance_norm(xl, weight=wl, bias=bl, eps=1e-5)
        ms = timed(lambda: inorm.instance_norm_act_backward_cuda(x, g, mean, rstd, scale, bias),
                   flush=flush)
        plain = timed(lambda: inorm.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5,
                                                                     "relu", (mean, rstd)),
                      flush=flush)
        lib = timed(lambda: torch.autograd.grad(yl, (xl, wl, bl), g, retain_graph=True),
                    flush=flush)
        del yl, xl
        # x and g read once, dx written once; ~20 flops per element
        bytes_ms = 1e3 * 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S
        ops_ms = 1e3 * 20 * x.numel() / PEAK_FLOPS["float32"]
        bound = max(bytes_ms, ops_ms)
        where = f"{plan.path} k={plan.k} ppc={plan.ppc}"
        log(f"instance_norm_act backward {dname:8s} {tuple(x.shape)} ({where}): kernel "
            f"{ms:.4f} ms ({100 * bound / ms:.1f}% of bound), plain twin {plain:.4f} ms, "
            f"F.instance_norm's backward (no ReLU mask) {lib:.4f} ms, bound {bound:.4f} ms, "
            f"max|err| of dx {err:.3g}, two calls bit-identical [{card}]")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound),
                     ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
        tot["paths"][f"{c}x{hw}x{hw}"] = {"path": where, "ms": ms, "library_ms": lib,
                                          "bound_ms": bound}
        del x, g
    log(f"instance_norm_act backward {dname}, six sites: kernel {tot['ms']:.4f} ms "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of bound), F.instance_norm's backward "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms [{card}]")
    return tot


def norm_site_numbers(nets, dtype, gen, flush, card):
    """The norm kernel at every site the flagship step fuses: ``nets`` is
    ((generator config, backward), ...), each net's ``fused_norm_sites``
    (packed blocks, SIZE px) run forward once a step and, where
    ``backward``, backward once.  At each distinct (C, H = W, activation),
    batch BATCH, the forward kernel against the plain version and the
    backward kernel against its plain twin (``_check_norm``,
    ``_check_norm_bwd``: relu sites and ``pw_bn``'s none), then each timed
    alone beside its plain version and its bound (forward: x read, y
    written; backward: x and g read, dx written).  Logs one line a shape and
    one step's totals by layer (trunk, blocks, upsampling); returns those
    totals, forward and backward apart."""
    import collections

    import torch

    from cat_tpu_torch.models.generator import fused_norm_sites
    from cat_tpu_torch.ops import instance_norm as inorm

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[-1]
    calls = collections.Counter()  # (direction, layer, C, H, act) -> calls a step
    for cfg, backward in nets:
        for layer, c, hw, act in fused_norm_sites(cfg, True, SIZE):
            calls[("forward", layer, c, hw, act)] += 1
            calls[("backward", layer, c, hw, act)] += backward
    per = {}  # (direction, C, H, act) -> (ms, plain ms, bytes ms, ops ms, max |err|)
    n_shape = collections.Counter()  # (direction, C, H, act) -> calls a step
    for (d, _, c, hw, act), n in calls.items():
        n_shape[(d, c, hw, act)] += n
    for c, hw, act in sorted({key[2:] for key in calls}):
        x = (torch.randn(BATCH, c, hw, hw, generator=gen, device=dev) * 3 + 1).to(dtype)
        g = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.randn(c, generator=gen, device=dev)
        fplan = inorm.norm_plan(hw * hw, x.element_size())
        bplan = inorm.norm_plan(hw * hw, x.element_size(), 2)
        ferr = _check_norm(x, scale, bias, act, fplan.path)
        berr, _ = _check_norm_bwd(x, g, scale, bias, bplan.path, act=act)
        _, mean, rstd = inorm.forward_cuda(x, scale, bias, 1e-5, act)
        fms = timed(lambda: inorm.forward_cuda(x, scale, bias, 1e-5, act), flush=flush)
        fplain = timed(lambda: inorm.instance_norm_act_plain(x, scale, bias, 1e-5, act),
                       flush=flush)
        bms = timed(lambda: inorm.instance_norm_act_backward_cuda(x, g, mean, rstd, scale, bias,
                                                                  act), flush=flush)
        bplain = timed(lambda: inorm.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act,
                                                                      (mean, rstd)), flush=flush)
        nbytes = x.numel() * x.element_size()
        # ~10 flops per element forward and ~20 backward, on CUDA cores
        per[("forward", c, hw, act)] = (fms, fplain, 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
                                        1e3 * 10 * x.numel() / PEAK_FLOPS["float32"], ferr)
        per[("backward", c, hw, act)] = (bms, bplain, 1e3 * 3 * nbytes / HBM_BYTES_PER_S,
                                         1e3 * 20 * x.numel() / PEAK_FLOPS["float32"], berr)
        pct = {d: 100 * max(per[(d, c, hw, act)][2:4]) / per[(d, c, hw, act)][0]
               for d in ("forward", "backward")}
        log(f"instance_norm_act site {dname:8s} {tuple(x.shape)} {act}: forward {fms:.4f} ms "
            f"({pct['forward']:.1f}% of bound; {fplan.path} k={fplan.k} ppc={fplan.ppc}), plain "
            f"{fplain:.4f} ms, max|err| {ferr:.3g}; backward {bms:.4f} ms ({pct['backward']:.1f}% "
            f"of bound; {bplan.path} k={bplan.k} ppc={bplan.ppc}), plain twin {bplain:.4f} ms, "
            f"max|err| of dx {berr:.3g}; calls a step {n_shape[('forward', c, hw, act)]} "
            f"forward, {n_shape[('backward', c, hw, act)]} backward [{card}]")
        del x, g, mean, rstd
    out = {}
    for direction in ("forward", "backward"):
        layers = {}
        for (d, layer, c, hw, act), n in calls.items():
            if d != direction or not n:
                continue
            ms, plain, bytes_ms, ops_ms, err = per[(d, c, hw, act)]
            for key in (layer, "all"):
                t = layers.setdefault(key, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                            "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                                            "err": 0.0, "library_ms": None})
                t["calls"] += n
                for k, v in (("ms", ms), ("plain_ms", plain), ("bytes_ms", bytes_ms),
                             ("ops_ms", ops_ms), ("bound_ms", max(bytes_ms, ops_ms))):
                    t[k] += n * v
                t["err"] = max(t["err"], err)
        for key in sorted(layers, key=("trunk", "blocks", "upsampling", "all").index):
            t = layers[key]
            log(f"instance_norm_act {direction} {dname}, {key} sites: {t['calls']} calls a step, "
                f"kernel {t['ms']:.4f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of bound), "
                f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms [{card}]")
        out[direction] = {**layers["all"], "layers": layers}
    return out


ADM_BATCH = 16  # the ADM cell's batch (benchmark/traffic/ddpm_bf16_b16.json)


def _adm_gn_calls():
    """One step of the ADM cell's GroupNorm sites at 256 px: (direction, C,
    side, scale-shift, SiLU) -> calls, the teacher's (model_channels 256)
    forward and the student's (128) forward and backward."""
    import collections

    from cat_tpu_torch.models.adm import ADMConfig, group_norm_sites

    calls = collections.Counter()
    for mc, backward in ((256, False), (128, True)):
        for name, c, side in group_norm_sites(ADMConfig(model_channels=mc)):
            key = (c, side, name.endswith("out_layers.0"), not name.endswith(".norm"))
            calls[("forward", *key)] += 1
            calls[("backward", *key)] += backward
    return calls


def _check_gn(got, ref, what):
    """Max |got - ref| of a GroupNorm output or dx; fails unless within one
    bf16 rounding (2^-7 relative) plus 1e-3 of the largest value (both round
    the same float32 value once, which straddles a rounding boundary near
    0), or 1e-5 of both in float32 (sums in another order, ``__expf``)."""
    import torch

    torch.cuda.synchronize()
    ref = ref.float()
    rtol, atol = (1e-5, 1e-5) if got.dtype == torch.float32 else (2 ** -7, 1e-3)
    diff = (got.float() - ref).abs()
    excess = float((diff - rtol * ref.abs()).max())
    tol = atol * float(ref.abs().max()) + 1e-6
    if not excess <= tol or not torch.isfinite(got).all():
        fail(f"{what}: error beyond rtol {rtol:g} by {excess:g} > {tol:g}")
    return float(diff.max())


def _check_gn_sums(got, ref, mag, what):
    """dγ, dβ (sums of N·H·W float32 terms) or the scale-shift's gradient
    (of H·W terms) against the twin's, summed in another order: within 1e-5
    of the terms' magnitudes, plus one bf16 rounding of the gradient."""
    import torch

    tol = 1e-5 * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * ref.float().abs()
    gap = (got.float() - ref.float()).abs()
    if not bool((gap <= tol).all()) or not torch.isfinite(got).all():
        fail(f"{what}: max |err| {float(gap.max()):g}, beyond 1e-5 of the terms' magnitudes")


def _check_gn_site(x, g, w, b, e, silu, what):
    """The forward and backward kernels against the plain twin at one
    site (32 groups): y and dx by ``_check_gn``, dγ, dβ and the (N, 2C)
    scale-shift gradient by ``_check_gn_sums``.  Returns (max |err| of y,
    of dx, the forward's mean and rstd)."""
    import torch

    from cat_tpu_torch.ops import group_norm as gn

    y, mean, rstd = gn.forward_cuda(x, 32, w, b, 1e-5, e, silu)
    ferr = _check_gn(y, gn.group_norm_act_plain(x, 32, w, b, 1e-5, e, silu), what + " forward")
    got = gn.backward_cuda(x, g, 32, mean, rstd, w, b, e, silu)
    ref = gn.group_norm_act_backward_plain(x, g, 32, w, b, 1e-5, e, silu)
    berr = _check_gn(got[0], ref[0], what + " dx")
    n, c = x.shape[:2]
    xf = x.float().reshape(n, 32, -1)
    xh = ((xf - mean[..., None]) * rstd[..., None]).reshape(n, c, -1)
    du = g.float().reshape(n, c, -1).abs()
    scale = 1 + e.float()[:, :c] if e is not None else torch.ones((n, c), device=x.device)
    if silu:
        u = (xh * w[:, None] + b[:, None]) * scale[..., None]
        if e is not None:
            u = u + e.float()[:, c:, None]
        sg = torch.sigmoid(u)
        du = du * (sg * (1 + u * (1 - sg))).abs()
    mp, mq = du.sum(-1), (du * xh.abs()).sum(-1)  # Σ|du|, Σ|du·x̂| a channel
    del xf, xh, du
    _check_gn_sums(got[1], ref[1], (scale.abs() * mq).sum(0), what + " dweight")
    _check_gn_sums(got[2], ref[2], (scale.abs() * mp).sum(0), what + " dbias")
    if e is not None:
        _check_gn_sums(got[3], ref[3], torch.cat([w.abs() * mq + b.abs() * mp, mp], 1),
                       what + " demb")
    return ferr, berr, mean, rstd


def _nhwc(t):
    """t stored channels innermost, as the channels-last UNet holds its
    activations: channels_last for (N, C, H, W), an (N, C, T) view of an
    (N, T, C) tensor for (N, C, T)."""
    return t.movedim(1, -1).contiguous().movedim(-1, 1)


def group_norm_site_numbers(gen, flush, card):
    """The GroupNorm kernels at every site shape of the ADM cell's step
    (bf16, batch ADM_BATCH, 256 px), in the layout the channels-last UNet
    hands them (channels_last; the attention norm's (N, C, T) view stored
    (N, T, C)): at each (C, side, scale-shift, SiLU) the NHWC forward and
    backward on their planned paths, checked against the plain twin
    (``_check_gn_site``; fails unless the layout counter read "nhwc"), then
    timed alone beside the bytes bound (forward: x read, the output
    written; backward: x and g read, dx written), the NCHW kernels at the
    same site on a contiguous copy (checked too), the plain twin and the
    library yardstick (ATen's ``F.group_norm`` on the bf16 activation in the
    same layout with bf16 γ and β, ``addcmul`` where the site scales, and
    ``F.silu``; its backward is autograd's through them, timed alone on a
    recorded forward).  Logs a line a shape and one step's totals; returns
    them, forward and backward apart, with the 0.5-2 MiB slabs' share of
    bound."""
    import torch
    import torch.nn.functional as F

    from cat_tpu_torch.ops import group_norm as gn

    dev = torch.device("cuda")
    calls = _adm_gn_calls()
    per = {}  # (direction, C, side, ss, silu) -> numbers
    for c, side, ss, silu in sorted({key[1:] for key in calls}):
        attention = not (ss or silu)
        shape = (ADM_BATCH, c, side * side) if attention else (ADM_BATCH, c, side, side)
        xc = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).bfloat16()
        gc = torch.randn(shape, generator=gen, device=dev).bfloat16()
        x, g = _nhwc(xc), _nhwc(gc)
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev)
        e = ((torch.randn(ADM_BATCH, 2 * c, generator=gen, device=dev) * 0.5).bfloat16()
             if ss else None)
        cpg, hw = c // 32, side * side
        fplan, bplan = (gn.group_norm_nhwc_plan(ADM_BATCH, c, cpg, hw, 2, a) for a in (1, 2))
        what = f"group_norm_act {tuple(x.shape)} ss={int(ss)} silu={int(silu)}"
        before = dict(gn.layout_launches)
        ferr, berr, mean, rstd = _check_gn_site(x, g, w, b, e, silu, what + " NHWC")
        if gn.layout_launches["nhwc"] != before["nhwc"] + 2:
            fail(f"{what}: channels innermost did not take the NHWC kernels")
        _check_gn_site(xc, gc, w, b, e, silu, what + " NCHW")
        fms = timed(lambda: gn.forward_cuda(x, 32, w, b, 1e-5, e, silu), flush=flush)
        bms = timed(lambda: gn.backward_cuda(x, g, 32, mean, rstd, w, b, e, silu), flush=flush)
        nchw_f = timed(lambda: gn.forward_cuda(xc, 32, w, b, 1e-5, e, silu), flush=flush)
        nchw_b = timed(lambda: gn.backward_cuda(xc, gc, 32, mean, rstd, w, b, e, silu),
                       flush=flush)
        fplain = timed(lambda: gn.group_norm_act_plain(x, 32, w, b, 1e-5, e, silu), flush=flush,
                       iters=5)
        bplain = timed(lambda: gn.group_norm_act_backward_plain(x, g, 32, w, b, 1e-5, e, silu),
                       flush=flush, iters=5)
        wl, bl = w.bfloat16(), b.bfloat16()
        leaves = [t.detach().requires_grad_(True) for t in (x, wl, bl) + ((e,) if ss else ())]
        spatial = [1] * (x.dim() - 2)

        def library():
            out = F.group_norm(leaves[0], 32, leaves[1], leaves[2], 1e-5)
            if ss:
                scale, shift = leaves[3].reshape(ADM_BATCH, 2 * c, *spatial).chunk(2, 1)
                out = torch.addcmul(shift, out, 1 + scale)
            return F.silu(out) if silu else out

        with torch.no_grad():
            lfwd = timed(library, flush=flush, iters=10)
        recorded = library()  # the graph autograd's backward walks, outside the timing
        lbwd = timed(lambda: torch.autograd.grad(recorded, leaves, g, retain_graph=True),
                     flush=flush, iters=10)
        del recorded
        nbytes = x.numel() * x.element_size()
        for direction, ms, nchw, plain, lib, nb, err, plan in (
                ("forward", fms, nchw_f, fplain, lfwd, 2 * nbytes, ferr, fplan),
                ("backward", bms, nchw_b, bplain, lbwd, 3 * nbytes, berr, bplan)):
            per[(direction, c, side, ss, silu)] = {
                "ms": ms, "nchw_ms": nchw, "plain_ms": plain, "library_ms": lib,
                "bytes_ms": 1e3 * nb / HBM_BYTES_PER_S, "err": err,
                "slab_kib": cpg * hw * 2 / 1024, "plan": plan._asdict()}
        pf, pb = per[("forward", c, side, ss, silu)], per[("backward", c, side, ss, silu)]
        log(f"group_norm site {tuple(x.shape)} NHWC ss={int(ss)} silu={int(silu)} slab "
            f"{pf['slab_kib']:.0f} KiB: forward {fms:.4f} ms ({100 * pf['bytes_ms'] / fms:.1f}% "
            f"of bound; {fplan.path} wc={fplan.wc} k={fplan.k}), NCHW kernels {nchw_f:.4f} ms, "
            f"plain {fplain:.4f} ms, library {lfwd:.4f} ms, max|err| {ferr:.3g}; backward "
            f"{bms:.4f} ms ({100 * pb['bytes_ms'] / bms:.1f}% of bound; {bplan.path} "
            f"wc={bplan.wc} k={bplan.k}), NCHW kernels {nchw_b:.4f} ms, plain twin "
            f"{bplain:.4f} ms, library {lbwd:.4f} ms, max|err| of dx {berr:.3g}; calls a step "
            f"{calls[('forward', c, side, ss, silu)]} forward, "
            f"{calls[('backward', c, side, ss, silu)]} backward [{card}]")
        del x, g, xc, gc, e, mean, rstd, leaves
    out = {}
    for direction in ("forward", "backward"):
        tot = {"calls": 0, "ms": 0.0, "nchw_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "big_ms": 0.0,
               "big_bytes_ms": 0.0}
        for key, n in calls.items():
            if key[0] != direction or not n:
                continue
            p = per[key]
            tot["calls"] += n
            for k in ("ms", "nchw_ms", "plain_ms", "library_ms", "bytes_ms"):
                tot[k] += n * p[k]
            tot["err"] = max(tot["err"], p["err"])
            if 512 <= p["slab_kib"] <= 2048:
                tot["big_ms"] += n * p["ms"]
                tot["big_bytes_ms"] += n * p["bytes_ms"]
        tot["bound_ms"] = tot["bytes_ms"]
        tot["shapes"] = [{"C": k[1], "side": k[2], "scale_shift": k[3], "silu": k[4],
                          "calls": n, **per[k]} for k, n in sorted(calls.items())
                         if k[0] == direction and n]
        log(f"group_norm {direction} bf16 NHWC, every ADM site: {tot['calls']} calls a step, "
            f"kernel {tot['ms']:.3f} ms ({100 * tot['bytes_ms'] / tot['ms']:.1f}% of bound; "
            f"0.5-2 MiB slabs {100 * tot['big_bytes_ms'] / tot['big_ms']:.1f}%), NCHW kernels "
            f"{tot['nchw_ms']:.3f} ms ({100 * tot['bytes_ms'] / tot['nchw_ms']:.1f}%), plain "
            f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms [{card}]")
        out[direction] = tot
    return out


ADM_STEPS = 2  # counted steps of the ADM cell's program, after its own first steps


def adm_group_norm_step(card):
    """The ADM cell's program as the benchmark drives it (``benchmark/
    families/adm_ka.py``'s ``Cell``: ``GenericDistiller.train_step`` at the
    cell's widths, 256 px, batch ADM_BATCH, bf16, after the cell's own three
    check steps), ADM_STEPS steps with the GroupNorm counters set to 0
    just before them: fails unless each step launched the forward once a
    site in both nets and the backward once a student site, every one on
    the NHWC kernels; then one more step under ``torch.profiler``: fails
    unless it ran no kernel named ``nchwToNhwc`` or ``nhwcToNchw``.
    Returns the counts a step, by path and layout, the transposes and the
    steps' wall milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.families import adm_ka
    from cat_tpu_torch import import_stdlib_profile
    from cat_tpu_torch.models.adm import ADMConfig, group_norm_sites
    from cat_tpu_torch.ops import group_norm as gn

    import_stdlib_profile()  # the profiler loads TorchDynamo, which imports ``profile``
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "benchmark", "configs", "adm256_palette.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", "ddpm_bf16_b16.json")) as f:
        traffic = json.load(f)
    if traffic["batch"] != ADM_BATCH:
        fail(f"the ADM cell's batch is {traffic['batch']}, chip_smoke assumes {ADM_BATCH}")
    cell = adm_ka.Cell(config, traffic, 2 ** 31 + 23, torch.device("cuda"))
    torch.cuda.synchronize()
    gn.launches, gn.bwd_launches = 0, 0
    gn.path_launches = dict.fromkeys(gn.path_launches, 0)
    gn.layout_launches = dict.fromkeys(gn.layout_launches, 0)
    t0 = time.perf_counter()
    for k in range(ADM_STEPS):
        metrics = cell.step(k)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / ADM_STEPS
    sites = [len(group_norm_sites(ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                                               for k, v in spec.items()})))
             for spec in (cell.teacher, cell.student)]
    counts = {"forward": gn.launches / ADM_STEPS, "backward": gn.bwd_launches / ADM_STEPS,
              "forward_by_path": {k: v / ADM_STEPS for k, v in gn.path_launches.items()},
              "by_layout": {k: v / ADM_STEPS for k, v in gn.layout_launches.items()}}
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cell.step(ADM_STEPS)
        torch.cuda.synchronize()
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    transposes = sum(("nchwtonhwc" in n.lower() or "nhwctonchw" in n.lower()) for n in kernels)
    del cell, metrics, prof
    torch.cuda.empty_cache()
    if (counts["forward"] != sum(sites) or counts["backward"] != sites[1] or not finite
            or counts["by_layout"] != {"nchw": 0, "nhwc": sum(sites) + sites[1]}):
        fail(f"ADM step: GroupNorm launches a step {counts} (losses finite: {finite}); "
             f"expected {sum(sites)} forward ({sites[0]} teacher, {sites[1]} student) and "
             f"{sites[1]} backward, all on the NHWC kernels")
    if transposes:
        fail(f"ADM step: {transposes} kernels named nchwToNhwc/nhwcToNchw in a step; expected "
             f"none with the UNet channels-last")
    log(f"ADM step (the cell's program, batch {ADM_BATCH}, bf16): GroupNorm launches a step "
        f"{counts}; cuDNN transposes a step {transposes}; {len(kernels)} kernels in the "
        f"profiled step; {wall:.1f} ms a step by the host's clock [{card}]")
    return {**counts, "transposes": transposes, "profiled_kernels": len(kernels),
            "step_ms": wall}


def check_kernels(dev, teacher_cfg, student_cfg, card):
    """Each kernel against its plain version in bf16 and f32 at the step's
    shapes (the norm kernel's at the generators' own sites, ``fused_norm_sites``);
    returns the per-step numbers of each kernel at the main path's dtype
    (bf16)."""
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.models.generator import fused_norm_sites
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
    bc = teacher_cfg.ds_channels[-1], student_cfg.ds_channels[-1]
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
    # batches past 128 rows: the pair kernels at B = 256 on both taps'
    # shapes, the teacher's timed; B = 300 (a ragged last block of 44 rows),
    # in place and, with F % 8 != 0, on the padded copy, for correctness only
    for dtype in (torch.bfloat16, torch.float32):
        for b, f, time_it in ((PAIRS_BATCH, 64 * 64 * bc[0], True),
                              (PAIRS_BATCH, 64 * 64 * bc[1], False),
                              (300, 64 * 64 * bc[0], False), (300, 4096 * 3 + 2, False)):
            x = torch.randn(b, f, generator=gen, device=dev).relu_().to(dtype)
            res = gram_pairs_numbers(x, flush, card, time_it)
            if time_it:
                out[("gram_pairs", str(dtype).split(".")[-1])] = res
            del x

    # --- instance norm + affine + relu at stem / down0 / down1, both nets:
    # the forward on its planned path and forced onto the two-pass loop, the
    # backward kernel against its plain twin, each timed beside its bound
    planes = [(c, hw) for cfg in (teacher_cfg, student_cfg)
              for layer, c, hw, _ in fused_norm_sites(cfg, True, SIZE) if layer == "trunk"]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        out[("instance_norm_act", dname)] = norm_numbers(planes, dtype, gen, flush, card)
        out[("instance_norm_act_bwd", dname)] = norm_bwd_numbers(planes, dtype, gen, flush, card)
    # every site the flagship step fuses, at its dtype: the teacher's
    # forward, the student's forward and backward
    out["norm_sites"] = norm_site_numbers(((teacher_cfg, False), (student_cfg, True)),
                                          torch.bfloat16, gen, flush, card)
    # the path the flagship's planes never take natively: a plane whose bytes
    # are not a multiple of 16 (255²), forward and backward
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(16, 8, 255, 255, generator=gen, device=dev) * 3 + 1).to(dtype)
        scale = torch.rand(8, generator=gen, device=dev) + 0.5
        bias = torch.randn(8, generator=gen, device=dev)
        g = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        before = dict(inorm.path_launches), dict(inorm.bwd_path_launches)
        _check_norm(x, scale, bias, "relu", "two-pass")
        _check_norm_bwd(x, g, scale, bias, "two-pass")
        # two forward launches (the check's and the backward's statistics), two backward
        if (inorm.path_launches["two_pass"] != before[0]["two_pass"] + 2
                or inorm.bwd_path_launches["two_pass"] != before[1]["two_pass"] + 2):
            fail(f"instance norm {tuple(x.shape)} {dtype}: not the two-pass path")
        log(f"instance_norm_act {tuple(x.shape)} {dtype}: two-pass path, forward and backward "
            f"within tolerance")
    # ADM's GroupNorm chain at every site of its cell's step
    out["group_norm_sites"] = group_norm_site_numbers(gen, flush, card)
    out["adm_step"] = adm_group_norm_step(card)
    del l2
    return out


# ---------------------------------------------------------------------------
# Phases 3-5: the KA-distillation step
# ---------------------------------------------------------------------------


def reference_check(dev, batch=2):
    """One float32 step at a tiny size on the card and on the CPU, from the
    same weights and batch: the kernels in context against the plain
    versions.  Returns the card step's Gram launches by path (batch > 128:
    the f32 pair kernel; the CPU takes ``gram_pairs_plain``) and its fused
    norm's forward and backward launches (``fused_norm_sites``: every norm
    of both nets forward, the student's backward)."""
    import torch

    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator, fused_norm_sites

    def cfg(ngf):
        return InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                             kernel_sizes=(1, 3, 5), n_blocks=2)

    teacher = InceptionGenerator(cfg(8), generator=torch.Generator().manual_seed(1))
    hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan", lambda_recon=5.0,
                        mapping_layers=("encode", "block1"), fused_norms=True,
                        packed_blocks=False)
    x = torch.randn(batch, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    batch_ = {"A": x, "B": x.flip(0)}
    losses = []
    for d in (dev, torch.device("cpu")):
        dist = InceptionDistiller(cfg(8), cfg(4), NLayerDiscriminatorConfig(ndf=8), hp, d)
        state, tp = dist.init_state(teacher.state_dict(), seed=3)
        if d == dev:
            torch.cuda.synchronize()
            ka.launches = 0
            ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
            norm_counts_reset()
        _, m = dist.train_step(state, tp, {k: v.to(d) for k, v in batch_.items()}, LR)
        if d == dev:
            torch.cuda.synchronize()
            counts = {"gram": ka.launches, **{p: n for p, n in ka.path_launches.items() if n},
                      **norm_counts()}
            # unpacked blocks: every instance norm of both nets is fused
            t_sites, s_sites = (len(fused_norm_sites(c, False, 32)) for c in (cfg(8), cfg(4)))
            if (counts["instance_norm_act"] != t_sites + s_sites
                    or counts["instance_norm_act_bwd"] != s_sites):
                fail(f"tiny f32 step at batch {batch}: norm launches {counts}, expected "
                     f"{t_sites + s_sites} forward ({t_sites} teacher, {s_sites} student) and "
                     f"{s_sites} backward (the student's)")
        losses.append({k: float(v) for k, v in m.items()})
    for k in losses[1]:
        # float32 throughout (TF32 off): sums in another order only
        if not math.isclose(losses[0][k], losses[1][k], rel_tol=1e-4, abs_tol=1e-5):
            fail(f"tiny f32 step at batch {batch}, {k}: card {losses[0][k]!r} vs CPU "
                 f"{losses[1][k]!r}")
    log(f"reference: tiny f32 step at batch {batch} on the card matches the CPU's (rtol 1e-4), "
        f"Gram launches {counts}: {losses[0]}")
    return counts


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


def norm_counts_reset():
    from cat_tpu_torch.ops import instance_norm as inorm

    inorm.launches = inorm.bwd_launches = 0
    for d in (inorm.path_launches, inorm.bwd_path_launches):
        d.update(dict.fromkeys(d, 0))


def norm_counts():
    """The norm kernel's forward and backward launches since the reset, and
    each by path (the paths taken)."""
    from cat_tpu_torch.ops import instance_norm as inorm

    return {"instance_norm_act": inorm.launches, "instance_norm_act_bwd": inorm.bwd_launches,
            "norm_paths": {p: n for p, n in inorm.path_launches.items() if n},
            "norm_bwd_paths": {p: n for p, n in inorm.bwd_path_launches.items() if n}}


def run_steps(dev, teacher_cfg, teacher_sd, student_cfg, fused, n_steps, batch_size=BATCH,
              compute_dtype="bfloat16"):
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller

    hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan", distill_loss_type="ka",
                        lambda_recon=5.0, lambda_distill=1.0, compute_dtype=compute_dtype,
                        fused_norms=fused, packed_blocks=True)
    dist = InceptionDistiller(teacher_cfg, student_cfg, hp=hp, device=dev)
    state, tparams = dist.init_state(teacher_sd, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randn(batch_size, 3, SIZE, SIZE, generator=gen, device=dev) for k in "AB"}
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    norm_counts_reset()
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = dist.train_step(state, tparams, batch, LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"gram": ka.launches, "gram_tma": ka.path_launches["tma"],
              "gram_tma_pairs": ka.path_launches["tma_pairs"],
              "gram_f32tma_pairs": ka.path_launches["f32tma_pairs"], **norm_counts()}

    vals = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        fail(f"non-finite losses: {vals}")
    out = dist.generate_student(state, batch["A"][:2])
    if out.shape != (2, 3, SIZE, SIZE) or not torch.isfinite(out).all():
        fail(f"student output {tuple(out.shape)} not finite / wrong shape")
    return times, counts, vals, torch.cuda.max_memory_allocated()


# ---------------------------------------------------------------------------
# Phase 6: the distill verb
# ---------------------------------------------------------------------------

# scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh, but for the
# paths and the schedule (no --real_stat_path but in phase 7, a few epochs
# with a save at the end, losses printed every step)
RECIPE = ["--dataset_mode", "unaligned", "--distiller", "inception", "--gan_mode", "lsgan",
          "--teacher_ngf", "64", "--student_ngf", "20", "--ndf", "64",
          "--batch_size", str(VERB_BATCH), "--eval_batch_size", "2", "--norm_affine",
          "--norm_affine_D", "--channels_reduction_factor", "6", "--kernel_sizes", "1", "3", "5",
          "--lambda_distill", "1.0", "--lambda_recon", "5", "--prune_cin_lb", "16",
          "--target_flops", "2.6e9", "--distill_G_loss_type", "ka", "--nepochs_decay", "0",
          "--print_freq", "1"]


# scripts/cycle_gan/horse2zebra/evaluate_inception_student_2p6B.sh's profile
# flags, but for the paths
EVAL_RECIPE = ["--dataset_mode", "unaligned", "--gan_mode", "lsgan", "--norm_affine",
               "--norm_affine_D", "--channels_reduction_factor", "6", "--kernel_sizes", "1", "3",
               "5", "--prune_cin_lb", "16", "--target_flops", "2.6e9"]


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
    for side, n in (("trainA", VERB_IMAGES), ("trainB", VERB_IMAGES), *VAL_IMAGES.items()):
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


def _instrumented(setup, steps, starts, waits, after_step=None, on_run=None):
    """``setup`` (an entry's ``setup_distill``/``setup_train``) whose trainer
    times each step (host clock, ending in a synchronize), each fetch from
    the loader, and calls ``after_step(state)``; ``on_run(run)`` sees the
    run once it is set up."""
    import torch

    def instrumented(opt, device=None, loader=None):
        run = setup(opt, device, loader)
        if on_run is not None:
            on_run(run)
        step_fn = run.trainer.step_fn

        def timed_step(state, batch, lr):
            t0 = time.perf_counter()
            out = step_fn(state, batch, lr)
            torch.cuda.synchronize()
            starts.append(t0)
            steps.append(time.perf_counter() - t0)
            if after_step is not None:
                after_step(out[0])
            return out

        run.trainer.step_fn = timed_step
        run.trainer.dataloader = _TimedLoader(run.trainer.dataloader, waits)
        return run

    return instrumented


def _loop_numbers(steps, starts, waits, batch, mem, wall):
    """The median step (steps 2 on) and iteration, images/s of both, the
    host's wait on the loader and peak memory."""
    import numpy as np

    step_ms = 1e3 * float(np.median(steps[1:]))
    # from one step's start to the next: the step, the loader wait, logging
    iter_ms = 1e3 * float(np.median(np.diff(starts)))
    return {"steps": len(steps), "step_ms_median": step_ms,
            "step_ms": [round(1e3 * t, 1) for t in steps],
            "images_per_s": batch / (step_ms / 1e3), "iteration_ms_median": iter_ms,
            "images_per_s_with_loader": batch / (iter_ms / 1e3),
            "loader_wait_ms_per_step": 1e3 * sum(waits[1:]) / max(len(waits) - 1, 1),
            "loader_wait_ms_first": 1e3 * waits[0], "wall_s": wall,
            "peak_memory_gib": mem / 2 ** 30}


def _loop_line(out):
    return (f"median step {out['step_ms_median']:.1f} ms over steps 2-{out['steps']}, "
            f"{out['images_per_s']:.1f} images/s; median iteration "
            f"{out['iteration_ms_median']:.1f} ms, {out['images_per_s_with_loader']:.1f} "
            f"images/s; host wait on the loader {out['loader_wait_ms_per_step']:.1f} ms per step "
            f"(first fetch {out['loader_wait_ms_first']:.0f} ms), peak memory "
            f"{out['peak_memory_gib']:.2f} GiB")


def _same_output(net_a, net_b, x) -> bool:
    """Whether two networks give bit-identical outputs (cuDNN deterministic)."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            return torch.equal(net_a(x), net_b(x))
    finally:
        torch.backends.cudnn.deterministic = deterministic


def run_verb(root, label, extra, expect_path, dev, card, epochs=VERB_EPOCHS,
             teacher_g=None, teacher_d=None):
    """``entry.distill_main`` with the recipe's flags, ``extra`` and
    ``epochs`` epochs, from the teacher ``teacher_g`` and D ``teacher_d``
    (phase 6's by default); checks launches, checkpoints, reload and losses,
    and returns the run's numbers and the distill run."""
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    log_dir = os.path.join(root, f"log_{label}")
    teacher_g = teacher_g or os.path.join(root, "teacher", "best_A_net_G_A.pth")
    teacher_d = teacher_d or os.path.join(root, "teacher", "best_A_net_D_A.pth")
    argv = ["--dataroot", os.path.join(root, "data"), "--log_dir", log_dir,
            "--restore_teacher_G_path", teacher_g, "--restore_pretrained_G_path", teacher_g,
            "--restore_D_path", teacher_d,
            *RECIPE, "--nepochs", str(epochs), "--save_epoch_freq", str(epochs), *extra]
    steps, starts, waits = [], [], []
    setup = entry.setup_distill
    n_steps = epochs * VERB_IMAGES // VERB_BATCH
    entry.setup_distill = _instrumented(setup, steps, starts, waits)
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
    for name in ("latest_net_G.pth", "latest_net_G.json", f"{epochs}_net_G.pth",
                 "latest_state.pth"):
        if not os.path.exists(os.path.join(save_dir, name)):
            fail(f"verb ({label}): {name} was not written")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if any("loss" in k for k in r)]
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
    if not _same_output(gen, lambda y: run.distiller.generate_student(run.state, y), x[:4]):
        fail(f"verb ({label}): the reloaded student's output differs from the in-memory one")

    out = {"label": label, **_loop_numbers(steps, starts, waits, VERB_BATCH, mem, wall),
           "gram_launches": launches, "gram_path": expect_path,
           "last_losses": {k: v for k, v in rows[-1].items() if "loss" in k}}
    log(f"verb ({label}): {_loop_line(out)}, {launches} Gram launches ({expect_path}), fit "
        f"{wall:.1f} s, steps {out['step_ms']} [{card}]")
    return out, run, x


def native_status():
    """Whether the C++ image pipeline built on this machine (else its
    error); the bank and ``--data_backend native`` use it when it did."""
    from cat_tpu_torch.data import native

    t0 = time.perf_counter()
    built = native.load_pipe() is not None
    log(f"native image pipeline: "
        + (f"built ({time.perf_counter() - t0:.1f} s)" if built
           else f"not built, PIL decodes instead: {native.pipe_error()}"))
    return built


def check_bank_against_pil(run, root):
    """Run (b)'s bank, filled by the C++ pipeline, against PIL's bicubic
    resize of the same files: at most 3/255 per pixel and under 1/255 on
    average (the JAX package's bounds, tests/test_native_pipe.py)."""
    import numpy as np
    from PIL import Image

    from cat_tpu_torch.data.datasets import make_dataset

    bank = run.loader.dd.imgs_a.cpu().numpy()
    paths = make_dataset(os.path.join(root, "data", "trainA"))
    size = bank.shape[1]
    diff = np.concatenate([np.abs(bank[i].astype(int) - np.asarray(
        Image.open(p).convert("RGB").resize((size, size), Image.BICUBIC), int))
        for i, p in enumerate(paths)])
    if diff.max() > 3 or diff.mean() >= 1.0:
        fail(f"bank against PIL: max {diff.max()}, mean {diff.mean():.3f} (bounds 3 and 1)")
    log(f"verb (b): the bank ({bank.shape[0]} images at {size} px, filled by the C++ pipeline) "
        f"against PIL: max |diff| {diff.max()}/255, mean {diff.mean():.4f}/255 (bounds 3, 1)")


def distill_verb(dev, card, root, native_built):
    """Phase 6: the recipe through ``entry.distill_main``, (a) float32 with
    the host loader, (b) bfloat16 with the device bank and (c) float32 with
    the native loader where the pipeline built; the Gram kernel held against
    its plain version on (a)'s and (b)'s own (80, F) taps."""
    import torch

    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    results, kern = [], {}
    runs = [("a", [], torch.float32, "f32tma"),
            ("b", ["--compute_dtype", "bfloat16", "--on_device_data", "1"],
             torch.bfloat16, "tma")]
    if native_built:
        runs.append(("c", ["--data_backend", "native"], None, "f32tma"))
    for label, extra, dtype, path in runs:
        out, run, x = run_verb(root, label, extra, path, dev, card)
        if label == "b" and native_built:
            check_bank_against_pil(run, root)
        if dtype is not None:
            with torch.no_grad():
                taps = [net(x, taps=("encode",))[1]["encode"].reshape(x.shape[0], -1)
                        .to(dtype).contiguous()
                        for net in (run.distiller.netG_teacher, run.distiller.netG_student)]
            kern[label] = gram_numbers(taps, flush, card, path)
            del taps
        results.append(out)
        del run
    if native_built:
        a, c = results[0], results[2]
        log(f"verb: host wait on the loader per step, thread backend (a) "
            f"{a['loader_wait_ms_per_step']:.1f} ms, native backend (c) "
            f"{c['loader_wait_ms_per_step']:.1f} ms; iteration {a['iteration_ms_median']:.1f} "
            f"and {c['iteration_ms_median']:.1f} ms [{card}]")
    del l2
    return results, kern


# ---------------------------------------------------------------------------
# Phase 7: evaluation
# ---------------------------------------------------------------------------


class _Timer:
    """Wrap ``obj.name`` so each call adds its host seconds to ``total``."""

    def __init__(self, obj, name, sync=False):
        self.obj, self.name, self.fn, self.total = obj, name, getattr(obj, name), 0.0
        self.sync = sync

        def timed_call(*args, **kwargs):
            import torch

            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            self.total += time.perf_counter() - t0
            return out

        setattr(obj, name, timed_call)

    def restore(self):
        setattr(self.obj, self.name, self.fn)


def evaluation(dev, card, root):
    """Phase 7: statistics, a distill run with FID, profile and KID, through
    the verbs' entry points; returns its numbers."""
    import numpy as np
    import scipy
    import torch
    from PIL import Image

    from cat_tpu_torch import entry
    from cat_tpu_torch.metrics import fid
    from cat_tpu_torch.metrics.inception import load_inception, write_random_judge
    from cat_tpu_torch.train.evaluation import FIDEvaluator

    data = os.path.join(root, "data")
    judge = write_random_judge(os.path.join(root, "judge.pth"), seed=233)
    stats = os.path.join(root, "real_stat_B.npz")
    log(f"eval: scipy {scipy.__version__}, numpy {np.__version__}")

    # --- statistics of valB
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = entry.real_stat_main(["--dataroot", os.path.join(data, "valB"), "--inception_path",
                               judge, "--output_path", stats])
    stat_s = time.perf_counter() - t0
    if st["mu"].shape != (2048,) or not np.isfinite(st["sigma"]).all():
        fail("get_real_stat: statistics not finite or of the wrong width")
    n_real = VAL_IMAGES["valB"]
    log(f"eval: get_real_stat over {n_real} images: {stat_s:.2f} s, {n_real / stat_s:.1f} "
        f"images/s (decode, judge, statistics) [{card}]")

    # --- a distill run with FID at the trainer's cadence
    timers = [_Timer(FIDEvaluator, "__call__"), _Timer(fid, "get_activations", sync=True),
              _Timer(fid, "calculate_frechet_distance")]
    try:
        out, run, _ = run_verb(root, "eval", ["--compute_dtype", "bfloat16",
                                              "--on_device_data", "1", "--inception_path",
                                              judge, "--real_stat_path", stats],
                               "tma", dev, card, epochs=1)
    finally:
        for t in timers:
            t.restore()
    del run
    sweep_s, judge_s, frechet_s = (t.total for t in timers)
    log_dir = os.path.join(root, "log_eval")
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        fids = [r["metric/fid"] for r in map(json.loads, f) if "metric/fid" in r]
    best = os.path.join(log_dir, "checkpoints", "best_net_G.pth")
    if len(fids) != 2 or not all(math.isfinite(v) for v in fids) or not os.path.exists(best):
        fail(f"eval: FID values {fids} (expected 2, finite), best saved: {os.path.exists(best)}")
    log(f"eval: FID {fids} over {VAL_IMAGES['valA']} valA images at eval batch 2; the two "
        f"evaluations took {sweep_s:.2f} s: generator sweep and dumps "
        f"{sweep_s - judge_s - frechet_s:.2f} s, judge {judge_s:.2f} s, Fréchet distance on "
        f"the host {frechet_s:.2f} s [{card}]")

    # --- profile the best student, as the evaluate recipe does
    prof_dir = os.path.join(root, "profile")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prof = entry.profile_main([
        "--dataroot", data, "--log_dir", prof_dir,
        "--restore_teacher_G_path", os.path.join(root, "teacher", "best_A_net_G_A.pth"),
        "--pretrained_student_G_path", best, "--real_stat_path", stats,
        "--inception_path", judge, *EVAL_RECIPE])
    prof_s = time.perf_counter() - t0
    prof_mem = torch.cuda.max_memory_allocated()
    sfake = os.path.join(prof_dir, "eval", "latest", "Sfake")
    n_dumped = len(os.listdir(sfake))
    if n_dumped != VAL_IMAGES["valA"] or not math.isfinite(prof["metrics"]["metric/fid"]):
        fail(f"profile: {n_dumped} Sfake images, metrics {prof['metrics']}")
    log(f"profile: prune mean {prof['pruning_seconds_mean'] * 1e3:.2f} ms over 10 shrinks, "
        f"student {prof['student_macs']:,} MACs and {prof['student_params']:,} params "
        f"(FLOP counter {prof['counted_flops']:,}), latency {prof['latency_ms']:.3f} ms/image "
        f"at batch 1, FID {prof['metrics']['metric/fid']:.4f}, {n_dumped} images dumped, "
        f"peak memory {prof_mem / 2 ** 30:.2f} GiB, {prof_s:.1f} s in all [{card}]")

    # --- KID of the dump against valB
    t0 = time.perf_counter()
    kid_mean, kid_std = entry.kid_score_main(["--real", os.path.join(data, "valB"), "--fake",
                                              sfake, "--inception_path", judge])
    kid_s = time.perf_counter() - t0
    if not (math.isfinite(kid_mean) and math.isfinite(kid_std)):
        fail(f"kid_score: {kid_mean}, {kid_std}")
    log(f"kid_score: {kid_mean:.6f} +/- {kid_std:.6f} in {kid_s:.2f} s [{card}]")

    # --- the judge on the card against the CPU
    cpu_judge, card_judge = load_inception(judge, device="cpu"), load_inception(judge, device=dev)
    x = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(data, "valB", f"{i}.png"))
                                              .convert("RGB")) for i in range(4)])
                         .transpose(0, 3, 1, 2).copy()).float() / 255
    ref = cpu_judge(x)[0]
    got = card_judge(x.to(dev))[0].cpu()
    diff = float((got - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    if not diff <= tol:
        fail(f"judge: pool3 on the card differs from the CPU's by {diff:g} > {tol:g}")
    log(f"judge: pool3 of 4 images on the card against the CPU: max |diff| {diff:.3g} "
        f"(largest feature {float(ref.abs().max()):.3g}, tol {tol:.3g}), TF32 off in the judge")
    return {"real_stat_s": stat_s, "real_stat_images_per_s": n_real / stat_s,
            "fid": fids, "eval_s": sweep_s, "eval_sweep_s": sweep_s - judge_s - frechet_s,
            "eval_judge_s": judge_s, "eval_frechet_s": frechet_s, "verb": out,
            "profile_prune_ms": prof["pruning_seconds_mean"] * 1e3,
            "profile_latency_ms": prof["latency_ms"], "profile_peak_memory_gib":
            prof_mem / 2 ** 30, "profile_s": prof_s,
            "profile_fid": prof["metrics"]["metric/fid"],
            "kid": [kid_mean, kid_std], "kid_s": kid_s, "judge_card_vs_cpu_max_abs": diff}


# ---------------------------------------------------------------------------
# Phase 8: teacher training
# ---------------------------------------------------------------------------

TEACHER_BATCH = 32  # both teacher recipes' batch
TEACHER_EPOCHS = 1  # 160 images a side at batch 32: 5 steps an epoch
MAPS_TRAIN, MAPS_VAL = VERB_IMAGES, 40
ALPHA = (0.3, 0.8)  # 8a's fixed weights of the mixed gradient penalty

# scripts/cycle_gan/horse2zebra/train_inception_teacher.sh, but for the
# paths and the schedule (1 epoch, losses printed every step)
H2Z_TEACHER = ["--model", "cycle_gan", "--batch_size", str(TEACHER_BATCH), "--norm_affine",
               "--norm_affine_D", "--channels_reduction_factor", "6", "--kernel_sizes", "1", "3",
               "5", "--nepochs", str(TEACHER_EPOCHS), "--nepochs_decay", "0", "--print_freq",
               "1"]
# scripts/pix2pix/map2sat/train_inception_teacher.sh, the same cuts
MAPS_TEACHER = ["--model", "pix2pix", "--batch_size", str(TEACHER_BATCH), "--lambda_recon", "10",
                "--nepochs", str(TEACHER_EPOCHS), "--nepochs_decay", "0", "--norm", "batch",
                "--norm_affine", "--norm_affine_D", "--norm_track_running_stats",
                "--channels_reduction_factor", "6", "--kernel_sizes", "1", "3", "5",
                "--save_epoch_freq", "50", "--save_latest_freq", "20000", "--eval_batch_size",
                "16", "--direction", "BtoA", "--print_freq", "1"]


def teacher_reference(dev):
    """8a: two tiny float32 steps of each teacher task on the card and on
    the CPU from the same weights and batches (pix2pix with tracked batch
    norm; pix2pix under wgangp with the penalty's α fixed on both; CycleGAN),
    losses and running statistics compared.  Each step starts both sides
    from the card's state: Adam turns float32 noise in near-zero gradients
    into whole ±lr steps (ROADMAP queue 3), which a second step would
    compound into the losses."""
    import torch

    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict

    from cat_tpu_torch.core.config import (InceptionGeneratorConfig, NLayerDiscriminatorConfig,
                                           NormConfig)
    from cat_tpu_torch.models import losses
    from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask
    from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask

    def cfgs(kind, d_in):
        norm = NormConfig(kind=kind, affine=True, track_running_stats=kind == "batch")
        return (InceptionGeneratorConfig.make(ngf=8, channels_reduction_factor=2,
                                              kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm),
                NLayerDiscriminatorConfig(input_nc=d_in, ndf=8, norm=norm))

    def pix2pix(mode):
        def make(d):
            task = Pix2PixTask(*cfgs("batch", 6), Pix2PixHParams(gan_mode=mode), d)
            return task, task.init_state(3)
        return make

    def cyclegan(d):
        task = CycleGANTask(*cfgs("instance", 3), CycleGANHParams(), d)
        return task, task.init_state(32, 32, 3)

    mixing = losses.mixing_weights
    losses.mixing_weights = lambda n, generator, like: torch.tensor(
        ALPHA, dtype=like.dtype, device=like.device).reshape(n, 1, 1, 1)
    gen = torch.Generator().manual_seed(4)
    batches = [{k: torch.randn(2, 3, 32, 32, generator=gen) for k in "AB"} for _ in range(2)]
    try:
        for name, make in (("pix2pix, tracked batch norm, hinge", pix2pix("hinge")),
                           ("pix2pix, tracked batch norm, wgangp (α fixed)", pix2pix("wgangp")),
                           ("CycleGAN, instance norm, lsgan", cyclegan)):
            sides = [make(d) for d in (dev, torch.device("cpu"))]
            card_l, cpu_l = [], []
            for b in batches:
                sd = train_state_dict(sides[0][1])
                del sd["rng"]  # a card generator's state is no CPU generator's
                load_train_state_dict(sides[1][1], sd)
                for (task, state), ls in zip(sides, (card_l, cpu_l)):
                    d = task.device
                    _, m = task.train_step(state, {k: v.to(d) for k, v in b.items()}, LR)
                    ls.append({k: float(v) for k, v in m.items()})
            card_s, cpu_s = ({f"{net}.{k}": v.cpu() for net, ns in (("G", st.g), ("D", st.d))
                              for k, v in ns.stats.items()} for _, st in sides)
            for i, (a, b) in enumerate(zip(card_l, cpu_l)):
                for k in b:
                    if not math.isclose(a[k], b[k], rel_tol=1e-4, abs_tol=1e-5):
                        fail(f"8a {name}, step {i + 1}, {k}: card {a[k]!r} vs CPU {b[k]!r}")
            stat_err = max((float((card_s[k] - v).abs().max()) for k, v in cpu_s.items()),
                           default=0.0)
            if not all(torch.allclose(card_s[k], v, rtol=1e-4, atol=1e-5)
                       for k, v in cpu_s.items()):
                fail(f"8a {name}: running statistics differ from the CPU's by {stat_err:g}")
            log(f"teacher 8a: {name}: 2 f32 steps on the card match the CPU's, each from the "
                f"card's state (losses rtol 1e-4; {len(cpu_s)} running statistics, max |diff| "
                f"{stat_err:.3g}): {card_l[-1]}")
    finally:
        losses.mixing_weights = mixing


def write_maps_inputs(root) -> str:
    """An aligned dataset of seeded 512x256 A|B PNGs (maps' layout: each
    half resized to 286 and cropped to 256) in train and val, and the val
    set's A halves alone, for their statistics; returns that folder."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(1)
    val_a = os.path.join(root, "maps_valA")
    os.makedirs(val_a)
    for split, n in (("train", MAPS_TRAIN), ("val", MAPS_VAL)):
        d = os.path.join(root, "maps", split)
        os.makedirs(d)
        for i in range(n):
            ab = rs.randint(0, 256, (SIZE, 2 * SIZE, 3), dtype=np.uint8)
            Image.fromarray(ab).save(os.path.join(d, f"{i}.png"))
            if split == "val":
                Image.fromarray(ab[:, :SIZE]).save(os.path.join(val_a, f"{i}.png"))
    return val_a


def run_train_verb(root, label, argv, dev, card, nets):
    """``entry.train_main`` with ``argv`` (its FID evaluations timed),
    checks the checkpoints of ``nets`` and the logged losses and FID;
    returns the run's numbers, the run, the pools' fill after each step and
    the FID values."""
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.train.evaluation import FIDEvaluator

    log_dir = os.path.join(root, f"log_{label}")
    steps, starts, waits, pool_fill = [], [], [], []
    setup = entry.setup_train
    entry.setup_train = _instrumented(
        setup, steps, starts, waits,
        lambda state: pool_fill.append([p.count for p in state.pools.values()]))
    timer = _Timer(FIDEvaluator, "__call__", sync=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = entry.train_main(["--log_dir", log_dir, *argv])
        wall = time.perf_counter() - t0
    finally:
        entry.setup_train = setup
        timer.restore()
    mem = torch.cuda.max_memory_allocated()
    n_steps = TEACHER_EPOCHS * VERB_IMAGES // TEACHER_BATCH  # both data sets: 160 a side
    save_dir = os.path.join(log_dir, "checkpoints")
    missing = [f for f in [f"latest_net_{n}.{e}" for n in nets for e in ("pth", "json")]
               + ["latest_state.pth"] if not os.path.exists(os.path.join(save_dir, f))]
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = list(map(json.loads, f))
    losses = [v for r in rows for k, v in r.items() if "loss" in k]
    fids = [v for r in rows for k, v in r.items()
            if k.startswith("metric/fid") and not k.endswith(("-mean", "-best"))]
    if (len(steps) != n_steps or missing or not all(math.isfinite(v) for v in losses + fids)
            or len(fids) != 2):
        fail(f"teacher {label}: {len(steps)} steps (expected {n_steps}), missing {missing}, "
             f"FID {fids} (expected 2, the startup probe and the end), losses finite: "
             f"{all(math.isfinite(v) for v in losses)}")
    last = [r for r in rows if any("loss" in k for k in r)][-1]
    out = {"label": label, **_loop_numbers(steps, starts, waits, TEACHER_BATCH, mem, wall),
           "eval_s": timer.total, "fid": fids,
           "last_losses": {k: v for k, v in last.items() if "loss" in k}}
    log(f"teacher {label}: {_loop_line(out)}; two evaluations {timer.total:.2f} s (FID {fids}), "
        f"fit {wall:.1f} s, steps {out['step_ms']} [{card}]")
    return out, run, pool_fill


def train_h2z(dev, card, root, judge, stats):
    """8b: the horse2zebra CycleGAN teacher recipe at batch 32 over phase 6's
    unaligned PNGs for 5 steps, fid_B against phase 7's statistics; with
    --remat 1 where batch 32 does not fit the card without it."""
    import gc

    import torch

    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    argv = ["--dataroot", os.path.join(root, "data"), *H2Z_TEACHER, "--inception_path", judge,
            "--real_stat_B_path", stats]
    nets = ["G_A", "G_B", "D_A", "D_B"]
    oom = None
    try:
        res = run_train_verb(root, "8b", argv, dev, card, nets)
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError, or a library's allocation
        if not (isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)):
            raise
        oom = str(e).splitlines()[0]
    if oom is not None:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"teacher 8b: batch {TEACHER_BATCH} without --remat does not fit the card "
            f"({oom}); running the recipe with --remat 1, the JAX package's own flag, at the "
            f"same batch")
        shutil.rmtree(os.path.join(root, "log_8b"), ignore_errors=True)
        res = run_train_verb(root, "8b", [*argv, "--remat", "1"], dev, card, nets)
    out, run, pool_fill = res
    out["remat"] = oom is not None
    full = min(50, 2 * TEACHER_BATCH)  # the recipe's pool of 50 is full after step 2
    if pool_fill[1] != [full, full]:
        fail(f"teacher 8b: the pools hold {pool_fill[1]} after step 2, expected {full} each")
    x = next(iter(run.loader))["A"][:4].to(dev)
    sd, cfg = ckpt.load_net(os.path.join(root, "log_8b", "checkpoints"), "latest", "G_A")
    gen = InceptionGenerator(cfg, packed_blocks=True).to(dev)
    gen.load_state_dict(sd)
    if not _same_output(gen, lambda y: run.task.generate(run.state, y, "AtoB"), x):
        fail("teacher 8b: the reloaded G_A's output differs from the in-memory G_A's")
    log(f"teacher 8b: pools {pool_fill[1]} after step 2; G_A, G_B, D_A, D_B and the state "
        f"written; the reloaded G_A gives the in-memory G_A's output exactly")
    return out


def train_maps(dev, card, root, judge):
    """8c: the map2sat pix2pix teacher recipe (tracked batch norm, BtoA) at
    batch 32 over seeded aligned 512x256 PNGs for 5 steps, FID of G's A
    images against the val set's A halves."""
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    val_a = write_maps_inputs(root)
    stats = os.path.join(root, "real_stat_maps_A.npz")
    entry.real_stat_main(["--dataroot", val_a, "--inception_path", judge, "--output_path",
                          stats])
    argv = ["--dataroot", os.path.join(root, "maps"), *MAPS_TEACHER, "--inception_path", judge,
            "--real_stat_path", stats]
    out, run, _ = run_train_verb(root, "8c", argv, dev, card, ["G", "D"])
    stats_now = {f"{n}.{k}": v for n, ns in (("G", run.state.g), ("D", run.state.d))
                 for k, v in ns.stats.items()}
    moved = [k for k, v in stats_now.items()
             if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                torch.ones_like(v))]
    if not stats_now or len(moved) != len(stats_now):
        fail(f"teacher 8c: {len(moved)} of {len(stats_now)} running statistics moved from (0, 1)")
    x = next(iter(run.loader))["A"][:4].to(dev)
    sd, cfg = ckpt.load_net(os.path.join(root, "log_8c", "checkpoints"), "latest", "G")
    gen = InceptionGenerator(cfg, packed_blocks=True).to(dev)
    gen.load_state_dict(sd)
    if not _same_output(gen, lambda y: run.task.generate(run.state, y), x):
        fail("teacher 8c: the reloaded G's eval-mode output differs from the in-memory G's")
    log(f"teacher 8c: all {len(stats_now)} running statistics of G and D moved from (0, 1); "
        f"the reloaded G gives the in-memory G's eval-mode output exactly")
    return out


# ---------------------------------------------------------------------------
# Phase 9: Cityscapes (mIoU in the pix2pix recipes, GauGAN teacher training)
# ---------------------------------------------------------------------------

CITY_LABEL_HW = (1024, 2048)  # the trainId maps: the DRN judge's resolution
CITY_PHOTO = (2048, 1024)  # a leftImg8bit photo's (w, h)
P2P_CITY_BATCH, P2P_CITY_STUDENT_BATCH, GAUGAN_BATCH = 32, 80, 16  # the recipes' batches
P2P_CITY_TRAIN, P2P_CITY_VAL = 80, 10  # 2 teacher steps and 1 student step an epoch
GAUGAN_TRAIN, GAUGAN_VAL, GAUGAN_EPOCHS = 48, 10, 3  # 3 steps an epoch, 9 steps
DRN_SPEC_9A = dict(layers=(1, 1, 1, 1, 2, 1, 1, 1), channels=(4, 8, 8, 16, 16, 32, 32, 32),
                   classes=5)  # tests/fixtures/drn_fixture.npz's reduced DRN

# scripts/pix2pix/cityscapes/*_inception_*.sh, but for the paths and the schedule
P2P_CITY_NORMS = ["--norm", "batch", "--norm_affine", "--norm_affine_D",
                  "--norm_track_running_stats", "--channels_reduction_factor", "6",
                  "--kernel_sizes", "1", "3", "5", "--direction", "BtoA"]
P2P_CITY_TEACHER = ["--model", "pix2pix", "--batch_size", str(P2P_CITY_BATCH), "--lr", "0.0002",
                    "--nepochs", "2", "--nepochs_decay", "0", "--save_epoch_freq", "25",
                    "--save_latest_freq", "25000", "--print_freq", "1", *P2P_CITY_NORMS]
P2P_CITY_STUDENT = ["--distiller", "inception", "--nepochs", "2", "--nepochs_decay", "0",
                    "--save_epoch_freq", "25", "--save_latest_freq", "25000", "--teacher_ngf",
                    "64", "--student_ngf", "32", "--eval_batch_size", "2", "--batch_size",
                    str(P2P_CITY_STUDENT_BATCH),
                    "--lambda_distill", "0.5", "--prune_cin_lb", "16", "--target_flops", "5.6e9",
                    "--distill_G_loss_type", "ka", "--print_freq", "1", *P2P_CITY_NORMS]
P2P_CITY_EVAL = ["--distiller", "inception", "--eval_batch_size", "2", "--prune_cin_lb", "16",
                 "--target_flops", "5.6e9", *P2P_CITY_NORMS]
# scripts/gaugan/cityscapes/train_inception_teacher.sh, the same cuts
GAUGAN_TEACHER = ["--model", "spade", "--dataset_mode", "cityscapes", "--input_nc", "35",
                  "--contain_dontcare_label", "--preprocess", "scale_width", "--load_size",
                  "512", "--crop_size", "512", "--aspect_ratio", "2", "--ngf", "64",
                  "--batch_size", str(GAUGAN_BATCH), "--init_type", "xavier", "--nepochs",
                  str(GAUGAN_EPOCHS), "--nepochs_decay", "0", "--norm_G", "spadesyncbatch3x3",
                  "--netD", "multi_scale", "--channels_reduction_factor", "6", "--kernel_sizes",
                  "1", "3", "5", "--print_freq", "1"]


def city_reference(dev, card):
    """9a: a reduced DRN's logits and ``get_miou`` at a small size on the
    card against the CPU; two tiny float32 SPADE teacher steps (ngf 16,
    64x32, batch 2, VGG and the spectral multiscale D) on the card and on the
    CPU, each from the card's state: losses at rtol 1e-4, the parameters
    each optimizer step writes within twice the most one Adam step can move
    them at each net's TTUR rate, G's running statistics and D's ``u``."""
    import numpy as np
    import torch

    from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                 SPADEGeneratorConfig)
    from cat_tpu_torch.metrics import drn
    from cat_tpu_torch.models.vgg import VGG19Features, random_vgg19_state_dict
    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict
    from cat_tpu_torch.train.spade_model import SPADEHParams, SPADETask

    cpu = torch.device("cpu")
    judges = []
    for d in (dev, cpu):
        m = drn.DRNSeg(**{k: DRN_SPEC_9A[k] for k in ("classes", "layers", "channels")})
        m.load_state_dict(drn.drnseg_layout(drn.random_drnseg_state_dict(seed=9, **DRN_SPEC_9A)))
        judges.append(m.to(d))
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 3, 64, 128, generator=gen)
    ref = judges[1](x)
    got = judges[0](x.to(dev)).cpu()
    rel = float((got - ref).abs().max() / ref.abs().max())
    if not rel < 1e-4:
        fail(f"9a: the reduced DRN's logits on the card differ from the CPU's by {rel:g} (rel)")
    fakes = torch.rand(4, 3, 32, 64, generator=gen) * 2 - 1
    labels = [np.random.RandomState(i).randint(0, 5, (64, 128)).astype(np.uint8)
              for i in range(4)]
    labels[0][:8] = 255
    m_card, m_cpu = (drn.get_miou(fakes, labels, j, batch_size=2, target_hw=(64, 128))
                     for j in judges)
    preds = [drn.resize_bilinear(j(drn.normalize_for_drn(drn.resize_bilinear(
        (fakes.to(next(j.parameters()).device) + 1) / 2, (64, 128)))), (64, 128))
        .argmax(1).cpu() for j in judges]
    differ = int((preds[0] != preds[1]).sum())
    if differ or m_card != m_cpu:
        fail(f"9a: get_miou on the card {m_card} vs CPU {m_cpu}, {differ} of "
             f"{preds[0].numel()} argmax pixels differ")
    log(f"city 9a: reduced DRN logits card vs CPU rel {rel:.3g}; get_miou at 64x128 equal "
        f"({m_card}), all {preds[0].numel()} argmax pixels equal [{card}]")

    gcfg = SPADEGeneratorConfig.make(semantic_nc=37, ngf=16, channels_reduction_factor=6,
                                     kernel_sizes=(1, 3, 5), num_upsampling_layers="normal",
                                     crop_size=64, aspect_ratio=2.0)
    dcfg = MultiscaleDiscriminatorConfig(input_nc=40, ndf=16, n_layers=3, num_D=2)
    vgg_sd = random_vgg19_state_dict(seed=19)

    def make(d):
        vgg = VGG19Features()
        vgg.load_state_dict(vgg_sd)
        task = SPADETask(gcfg, dcfg, SPADEHParams(), vgg=vgg, input_nc=35,
                         contain_dontcare=True, device=d)
        return task, task.init_state(9)

    rs = np.random.RandomState(9)
    batches = []
    for _ in range(2):
        label = rs.randint(0, 34, (2, 32, 64)).astype(np.float32)
        label[:, :4] = 255
        inst = np.repeat(np.repeat(rs.randint(0, 9, (2, 4, 8)), 8, 1), 8, 2).astype(np.int32)
        batches.append({"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
                        "image": torch.rand(2, 3, 32, 64, generator=gen) * 2 - 1})
    sides = [make(d) for d in (dev, cpu)]
    card_l, cpu_l = [], []
    for b in batches:
        sd = train_state_dict(sides[0][1])
        del sd["rng"]
        load_train_state_dict(sides[1][1], sd)
        for (task, state), ls in zip(sides, (card_l, cpu_l)):
            _, m = task.train_step(state, {k: v.to(task.device) for k, v in b.items()}, LR)
            ls.append({k: float(v) for k, v in m.items()})
        for i, (a, c) in enumerate(zip(card_l[-1:], cpu_l[-1:])):
            for k in c:
                if not math.isclose(a[k], c[k], rel_tol=1e-4, abs_tol=1e-5):
                    fail(f"9a SPADE step {len(card_l)}, {k}: card {a[k]!r} vs CPU {c[k]!r}")
        param_err, param_bound = {}, {}
        for net, mult in zip(("g", "d"), sides[0][0].lr_mults):
            card_p, cpu_p = (getattr(st, net).params for _, st in sides)
            param_err[net] = max(float((v.detach().cpu() - cpu_p[k].detach()).abs().max())
                                 for k, v in card_p.items())
            # with TTUR's beta1 of 0, one Adam step at count t moves a
            # parameter by at most lr·sqrt((1 - beta2^t) / (1 - beta2)) (all
            # earlier gradients zero); a near-zero gradient whose sign the
            # two devices' float32 noise flips puts the sides twice that apart
            opt = getattr(sides[0][1], net).opt
            param_bound[net] = 2 * LR * mult * math.sqrt(
                (1 - opt.beta2 ** opt.count) / (1 - opt.beta2))
            if not param_err[net] <= param_bound[net]:
                fail(f"9a SPADE step {len(card_l)}: {net.upper()}'s parameters differ from the "
                     f"CPU's by {param_err[net]:g}, past Adam's one-step bound "
                     f"{param_bound[net]:g}")
        card_s, cpu_s = ({f"{net}.{k}": v.cpu() for net, ns in (("G", st.g), ("D", st.d))
                          for k, v in ns.stats.items() if not k.endswith("weight_v")}
                         for _, st in sides)
        err = max(float((card_s[k] - v).abs().max()) for k, v in cpu_s.items())
        if not all(torch.allclose(card_s[k], v, rtol=1e-4, atol=1e-5) for k, v in cpu_s.items()):
            fail(f"9a SPADE step {len(card_l)}: statistics and u differ from the CPU's by {err:g}")
    n_u = sum(k.endswith("weight_u") for k in cpu_s)
    log(f"city 9a: 2 f32 SPADE teacher steps (ngf 16, 64x32, batch 2, VGG, spectral D) on the "
        f"card match the CPU's, each from the card's state: losses rtol 1e-4, parameters "
        f"max |diff| G {param_err['g']:.3g} (bound {param_bound['g']:.3g}), D "
        f"{param_err['d']:.3g} (bound {param_bound['d']:.3g}), {len(cpu_s) - n_u} running "
        f"statistics and {n_u} spectral u, "
        f"max |diff| {err:.3g}: "
        f"{card_l[-1]} [{card}]")
    return {"drn_rel": rel, "miou": m_card, "spade_stats_max_abs": err,
            "spade_param_max_abs": param_err}


def _smooth_image(rs, w, h, channels=3):
    """A seeded image of 32 x 16 random blocks: compresses and decodes fast
    at 2048 x 1024."""
    import numpy as np

    small = rs.randint(0, 256, (16, 32, channels), dtype=np.uint8)
    return np.repeat(np.repeat(small, h // 16, 0), w // 32, 1)


def _trainid_map(rs):
    """A trainId map at the judge's resolution: 19 classes in blocks, a void
    (255) band."""
    import numpy as np

    small = rs.randint(0, 19, (16, 32)).astype(np.uint8)
    label = np.repeat(np.repeat(small, CITY_LABEL_HW[0] // 16, 0), CITY_LABEL_HW[1] // 32, 1)
    label[: CITY_LABEL_HW[0] // 16] = 255
    return label


def write_city_inputs(root):
    """The pix2pix Cityscapes data (aligned 512x256 A|B PNGs under a dataroot
    naming cityscapes), the GauGAN data (Cityscapes' own layout: 2048x1024
    leftImg8bit photos, labelIds with void, 16-bit instanceIds), trainId maps
    at 2048x1024 for both val sets with their tables, a full-spec DRN-D-105
    with seeded weights in the reference .pth layout, and seeded VGG19
    weights in torchvision's layout."""
    import numpy as np
    import torch
    from PIL import Image

    from cat_tpu_torch.metrics.drn import write_random_drnseg
    from cat_tpu_torch.models.vgg import random_vgg19_state_dict

    rs = np.random.RandomState(9)
    # pix2pix: train/val A|B and cityscapes-origin trainIds + table
    rows = []
    for split, n in (("train", P2P_CITY_TRAIN), ("val", P2P_CITY_VAL)):
        d = os.path.join(root, "cityscapes", split)
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(_smooth_image(rs, 512, 256)).save(os.path.join(d, f"{i}.png"))
            if split == "val":
                rel = f"gtFine/val/p2p/p2p_{i:06d}_gtFine_trainIds.png"
                os.makedirs(os.path.join(root, "cityscapes-origin", "gtFine", "val", "p2p"),
                            exist_ok=True)
                Image.fromarray(_trainid_map(rs)).save(os.path.join(root, "cityscapes-origin",
                                                                    rel))
                rows.append(f"{i} {rel} leftImg8bit/val/p2p/p2p_{i:06d}_leftImg8bit.png")
    with open(os.path.join(root, "table_p2p.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    # GauGAN: the dataset in Cityscapes' layout, its trainIds beside it
    rows = []
    base = os.path.join(root, "gaugan-origin")
    for split, n in (("train", GAUGAN_TRAIN), ("val", GAUGAN_VAL)):
        for sub in ("gtFine", "leftImg8bit"):
            os.makedirs(os.path.join(base, sub, split, "synth"))
        for i in range(n):
            stem = f"synth_{i:06d}_000019"
            lab = os.path.join(base, "gtFine", split, "synth", stem + "_gtFine_")
            small = rs.randint(0, 34, (16, 32)).astype(np.uint8)
            label = np.repeat(np.repeat(small, 64, 0), 64, 1)
            label[:64] = 255
            Image.fromarray(label).save(lab + "labelIds.png")
            inst = np.repeat(np.repeat(rs.randint(0, 30000, (16, 32)), 64, 0), 64, 1)
            Image.fromarray(inst.astype(np.uint16)).save(lab + "instanceIds.png")
            Image.fromarray(_smooth_image(rs, *CITY_PHOTO)).save(os.path.join(
                base, "leftImg8bit", split, "synth", stem + "_leftImg8bit.png"))
            if split == "val":
                Image.fromarray(_trainid_map(rs)).save(lab + "trainIds.png")
                rows.append(f"{stem} gtFine/val/synth/{stem}_gtFine_trainIds.png "
                            f"leftImg8bit/val/synth/{stem}_leftImg8bit.png")
    with open(os.path.join(root, "table_gaugan.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    write_random_drnseg(os.path.join(root, "drn-d-105_ms_cityscapes.pth"), seed=105)
    torch.save(random_vgg19_state_dict(seed=19), os.path.join(root, "vgg19.pth"))


class _EvalTimers:
    """The evaluations' host seconds: both evaluators' totals (their
    generator sweeps included), the FID judge, the host's Fréchet distance
    (``sqrtm``), the DRN judge and the confusion matrices."""

    def __init__(self):
        from cat_tpu_torch.metrics import drn, fid
        from cat_tpu_torch.train.evaluation import FIDEvaluator, MIoUEvaluator

        self.timers = {"fid_total": _Timer(FIDEvaluator, "__call__", sync=True),
                       "miou_total": _Timer(MIoUEvaluator, "__call__", sync=True),
                       "fid_judge": _Timer(fid, "get_activations", sync=True),
                       "sqrtm": _Timer(fid, "calculate_frechet_distance"),
                       "drn_judge": _Timer(drn.DRNSeg, "forward", sync=True),
                       "histogram": _Timer(drn, "fast_hist", sync=True)}

    def restore(self):
        for t in self.timers.values():
            t.restore()
        s = {k: t.total for k, t in self.timers.items()}
        s["generator_sweeps"] = (s["fid_total"] + s["miou_total"] - s["fid_judge"] - s["sqrtm"]
                                 - s["drn_judge"] - s["histogram"])
        return s

    @staticmethod
    def line(s):
        return (f"{s['fid_total'] + s['miou_total']:.2f} s: generator sweeps and dumps "
                f"{s['generator_sweeps']:.2f} s, FID judge {s['fid_judge']:.2f} s, host sqrtm "
                f"{s['sqrtm']:.2f} s, DRN judge {s['drn_judge']:.2f} s, histograms "
                f"{s['histogram']:.2f} s")


def _metric(log_dir, name):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [r[name] for r in map(json.loads, f) if name in r]


def _instrumented_run(entry_setup_name, main, argv, n_steps, batch, label, card, on_run=None):
    """``main(argv)`` with its steps, loader waits and evaluations timed;
    fails unless it ran ``n_steps`` steps with finite losses.  Returns the
    run's numbers and the run."""
    import torch

    from cat_tpu_torch import entry

    steps, starts, waits = [], [], []
    setup = getattr(entry, entry_setup_name)
    setattr(entry, entry_setup_name, _instrumented(setup, steps, starts, waits, on_run=on_run))
    timers = _EvalTimers()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = main(argv)
        wall = time.perf_counter() - t0
    finally:
        setattr(entry, entry_setup_name, setup)
        secs = timers.restore()
    mem = torch.cuda.max_memory_allocated()
    log_dir = argv[argv.index("--log_dir") + 1]
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if any("loss" in k for k in r)]
    losses = [v for r in rows for k, v in r.items() if "loss" in k]
    if len(steps) != n_steps or not losses or not all(math.isfinite(v) for v in losses):
        fail(f"city {label}: {len(steps)} steps (expected {n_steps}), losses finite: "
             f"{all(math.isfinite(v) for v in losses)}")
    out = {"label": label, **_loop_numbers(steps, starts, waits, batch, mem, wall),
           "eval": secs, "last_losses": {k: v for k, v in rows[-1].items() if "loss" in k}}
    log(f"city {label}: {_loop_line(out)}, fit {wall:.1f} s, steps {out['step_ms']} [{card}]")
    log(f"city {label}: evaluations {_EvalTimers.line(secs)} [{card}]")
    return out, run


def _check_miou(log_dir, label, n_evals, fid=True):
    mious = _metric(log_dir, "metric/mIoU")
    fids = _metric(log_dir, "metric/fid") if fid else []
    if (len(mious) != n_evals or not all(0.0 <= v <= 100.0 for v in mious)
            or (fid and (len(fids) != n_evals or not all(math.isfinite(v) for v in fids)))
            or not os.path.exists(os.path.join(log_dir, "checkpoints", "best_net_G.pth"))):
        fail(f"city {label}: mIoU {mious}, FID {fids} (expected {n_evals} each), best saved: "
             f"{os.path.exists(os.path.join(log_dir, 'checkpoints', 'best_net_G.pth'))}")
    return mious, fids


def city_pix2pix(dev, card, root, judge, stats):
    """9b: the pix2pix Cityscapes teacher recipe (4 steps at batch 32), the
    5.6e9-MAC student recipe from its best G and D (2 steps at batch 80, KA,
    8 Gram launches a step, held against the plain version on the run's own
    taps) and the evaluate recipe's profile, with mIoU (the full-spec DRN at
    2048x1024) and FID (phase 7's judge and statistics; the student's run
    evaluates mIoU alone)."""
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka

    paths = ["--dataroot", os.path.join(root, "cityscapes"),
             "--drn_path", os.path.join(root, "drn-d-105_ms_cityscapes.pth"),
             "--cityscapes_path", os.path.join(root, "cityscapes-origin"),
             "--table_path", os.path.join(root, "table_p2p.txt"), "--inception_path", judge]
    t_dir = os.path.join(root, "log_9b_teacher")
    teacher, run = _instrumented_run(
        "setup_train", entry.train_main,
        [*paths, "--log_dir", t_dir, "--real_stat_path", stats, *P2P_CITY_TEACHER],
        2 * (P2P_CITY_TRAIN // P2P_CITY_BATCH), P2P_CITY_BATCH, "9b teacher", card)
    del run
    teacher["miou"], teacher["fid"] = _check_miou(t_dir, "9b teacher", 2)
    best = os.path.join(t_dir, "checkpoints")

    s_dir = os.path.join(root, "log_9b_student")
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    student, run = _instrumented_run(
        "setup_distill", entry.distill_main,
        [*paths, "--log_dir", s_dir, "--restore_teacher_G_path",
         os.path.join(best, "best_net_G.pth"), "--restore_pretrained_G_path",
         os.path.join(best, "best_net_G.pth"), "--restore_D_path",
         os.path.join(best, "best_net_D.pth"), *P2P_CITY_STUDENT],
        2 * (P2P_CITY_TRAIN // P2P_CITY_STUDENT_BATCH), P2P_CITY_STUDENT_BATCH, "9b student",
        card)
    launches, on_path = ka.launches, ka.path_launches["f32tma"]
    if launches != 8 * student["steps"] or on_path != launches:
        fail(f"city 9b student: {launches} Gram launches in {student['steps']} steps, {on_path} "
             "of them 'f32tma'; expected 8 a step, all 'f32tma'")
    student["gram_launches"], student["gram_path"] = launches, "f32tma"
    student["miou"], _ = _check_miou(s_dir, "9b student", 2, fid=False)
    log(f"city 9b student: {launches} Gram launches in {student['steps']} steps "
        f"({launches // student['steps']} a step, f32tma), mIoU {student['miou']} [{card}]")
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    x = next(iter(run.loader))["A"].to(dev)
    with torch.no_grad():
        taps = [net(x, taps=("encode",))[1]["encode"].reshape(x.shape[0], -1).contiguous()
                for net in (run.distiller.netG_teacher, run.distiller.netG_student)]
    kern = gram_numbers(taps, l2.zero_, card, "f32tma")
    del taps, run, l2

    timers = _EvalTimers()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = entry.profile_main([*paths, "--log_dir", os.path.join(root, "eval_9b"),
                                   "--restore_teacher_G_path", os.path.join(best, "best_net_G.pth"),
                                   "--pretrained_student_G_path",
                                   os.path.join(s_dir, "checkpoints", "best_net_G.pth"),
                                   "--real_stat_path", stats, *P2P_CITY_EVAL])
        prof_s = time.perf_counter() - t0
    finally:
        secs = timers.restore()
    m = prof["metrics"]
    if not (0.0 <= m.get("metric/mIoU", -1.0) <= 100.0 and math.isfinite(m["metric/fid"])):
        fail(f"city 9b profile: metrics {m}")
    log(f"city 9b profile: student {prof['student_macs']:,} MACs, latency "
        f"{prof['latency_ms']:.3f} ms/image, FID {m['metric/fid']:.4f}, mIoU "
        f"{m['metric/mIoU']}, {prof_s:.1f} s in all; evaluation {_EvalTimers.line(secs)} "
        f"[{card}]")
    return {"teacher": teacher, "student": student,
            "profile": {"metrics": m, "seconds": prof_s, "eval": secs,
                        "latency_ms": prof["latency_ms"]}}, kern


def _record_eval(evals):
    """An ``on_run`` hook: at each evaluation, the first eval-mode batch the
    evaluators generate, the train-mode output of the same G on it (its
    statistics held) and the uint8 image the FID judge is given."""
    import torch

    from cat_tpu_torch.metrics.fid import tensor2im_batch
    from cat_tpu_torch.ops.nn import frozen_stats

    def on_run(run):
        task, generate_raw = run.task, run.task.generate_raw

        def recorded(state, batch):
            out = generate_raw(state, batch)
            if not evals or evals[-1]["step"] != state.step:
                with torch.no_grad(), frozen_stats(task.netG):
                    train_mode = task.netG(task.semantics(batch), train=True)
                evals.append({"step": state.step, "eval": out.float().cpu(),
                              "train_std": float(train_mode.float().std()),
                              "u8": tensor2im_batch(out)})
            return out

        task.generate_raw = recorded

    return on_run


def _eval_flatness(evals, n_evals, card):
    """The eval-mode output at each of a run's ``n_evals`` evaluations: its
    spread, how far it moved from one to the next, and how many uint8 levels
    the FID judge saw; fails on a non-finite output or one that did not move
    (a stale generator)."""
    import numpy as np

    finite = [bool(e["eval"].isfinite().all()) for e in evals]
    if len(evals) != n_evals or n_evals < 2 or not all(finite):
        fail(f"city 9c: {len(evals)} evaluations recorded (expected {n_evals}, at least 2), "
             f"finite: {finite}")
    moved = [float((b["eval"] - a["eval"]).abs().max()) for a, b in zip(evals, evals[1:])]
    if not all(moved):
        fail(f"city 9c: the eval-mode output did not move between evaluations at steps "
             f"{[e['step'] for e in evals]} ({moved}): the evaluators saw a stale generator")
    out = {"steps": [e["step"] for e in evals],
           "eval_std": [float(e["eval"].std()) for e in evals],
           "eval_max_abs": [float(e["eval"].abs().max()) for e in evals],
           "train_mode_std": [e["train_std"] for e in evals],
           "max_abs_change": moved,
           "uint8_levels": [int(np.unique(e["u8"]).size) for e in evals],
           "uint8_equal": [bool(np.array_equal(a["u8"], b["u8"]))
                           for a, b in zip(evals, evals[1:])]}
    log(f"city 9c: eval-mode output at steps {out['steps']}: std {out['eval_std']}, max |x| "
        f"{out['eval_max_abs']}; the same G in train mode (statistics held) std "
        f"{out['train_mode_std']}; max |change| from one evaluation to the next {moved}; "
        f"uint8 levels the FID judge saw {out['uint8_levels']}, equal to the previous "
        f"evaluation's images: {out['uint8_equal']} [{card}]")
    return out


def city_gaugan(dev, card, root, judge, stats):
    """9c: the GauGAN Cityscapes teacher recipe at full width (ngf 64,
    512x256, batch 16, 35 labels + dontcare + edges, spadesyncbatch3x3,
    spectral multiscale D, VGG, xavier, float32) for 9 steps, with FID and
    mIoU; with --remat 1 where batch 16 does not fit without it."""
    import gc

    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    data = os.path.join(root, "gaugan-origin")
    log_dir = os.path.join(root, "log_9c")
    argv = ["--dataroot", data, "--log_dir", log_dir, "--real_stat_path", stats,
            "--drn_path", os.path.join(root, "drn-d-105_ms_cityscapes.pth"),
            "--cityscapes_path", data, "--table_path", os.path.join(root, "table_gaugan.txt"),
            "--inception_path", judge, "--vgg_path", os.path.join(root, "vgg19.pth"),
            *GAUGAN_TEACHER]
    n_steps = GAUGAN_EPOCHS * (GAUGAN_TRAIN // GAUGAN_BATCH)
    evals = []
    oom = None
    try:
        out, run = _instrumented_run("setup_train", entry.train_main, argv, n_steps,
                                     GAUGAN_BATCH, "9c GauGAN", card, _record_eval(evals))
    except RuntimeError as e:
        if not (isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)):
            raise
        oom = str(e).splitlines()[0]
    if oom is not None:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"city 9c: batch {GAUGAN_BATCH} without --remat does not fit the card ({oom}); "
            "running the recipe with --remat 1")
        shutil.rmtree(log_dir, ignore_errors=True)
        evals.clear()
        out, run = _instrumented_run("setup_train", entry.train_main, [*argv, "--remat", "1"],
                                     n_steps, GAUGAN_BATCH, "9c GauGAN", card, _record_eval(evals))
    out["remat"] = oom is not None
    out["miou"], out["fid"] = _check_miou(log_dir, "9c GauGAN", 2)
    out["eval_output"] = _eval_flatness(evals, len(out["miou"]), card)
    save_dir = os.path.join(log_dir, "checkpoints")
    missing = [f for f in ("latest_net_G.pth", "latest_net_D.pth", "latest_state.pth")
               if not os.path.exists(os.path.join(save_dir, f))]
    stats_g = run.state.g.stats
    moved = [k for k, v in stats_g.items()
             if not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else
                                torch.ones_like(v))]
    if missing or not stats_g or len(moved) != len(stats_g):
        fail(f"city 9c: missing {missing}; {len(moved)} of {len(stats_g)} running statistics "
             "moved from (0, 1)")
    batch = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in next(iter(run.loader)).items()}
    sd, cfg = ckpt.load_net(save_dir, "latest", "G")
    gen = SPADEGenerator(cfg).to(dev)
    gen.load_state_dict(sd)
    sem = run.task.semantics(batch)[:4]
    if not _same_output(gen, lambda s: run.task.generate(run.state, s), sem):
        fail("city 9c: the reloaded G's eval output differs from the in-memory G's")
    n_u = sum(k.endswith("weight_u") for k in run.state.d.stats)
    log(f"city 9c: G, D ({n_u} spectral u) and the state written; all {len(stats_g)} running "
        f"statistics of G moved; the reloaded G gives the in-memory G's eval output exactly; "
        f"mIoU {out['miou']}, FID {out['fid']}, remat {out['remat']} [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 10: GauGAN (SPADE) distillation
# ---------------------------------------------------------------------------

GAUGAN_STUDENT_EPOCHS = 2  # 3 steps an epoch at batch 16: 6 steps
SPADE_TAPS = ("head_0", "G_middle_1", "up_1")  # the SPADE distiller's default taps
# scripts/gaugan/cityscapes/{train,evaluate}_inception_student_5p6B.sh, but
# for the paths and the schedule (its batch, widths and flags as shipped)
GAUGAN_COMMON = ["--distiller", "spade", "--dataset_mode", "cityscapes", "--input_nc", "35",
                 "--contain_dontcare_label", "--preprocess", "scale_width", "--load_size", "512",
                 "--crop_size", "512", "--aspect_ratio", "2", "--teacher_ngf", "64",
                 "--student_ngf", "48", "--teacher_norm_G", "spadesyncbatch3x3",
                 "--student_norm_G", "spadesyncbatch3x3", "--channels_reduction_factor", "6",
                 "--kernel_sizes", "1", "3", "5", "--prune_cin_lb", "16"]
GAUGAN_STUDENT = [*GAUGAN_COMMON, "--netD", "multi_scale", "--init_type", "xavier",
                  "--batch_size", str(GAUGAN_BATCH), "--nepochs", str(GAUGAN_STUDENT_EPOCHS),
                  "--nepochs_decay", "0", "--save_epoch_freq", "25", "--lambda_distill", "0.5",
                  "--target_flops", "5.6e9", "--distill_G_loss_type", "ka", "--print_freq", "1"]
GAUGAN_STUDENT_EVAL = [*GAUGAN_COMMON, "--eval_batch_size", "2", "--target_flops", "5.6e9"]
REMAT_STEPS = 3  # phase 10d: one epoch of the recipe


def spade_distill_reference(dev, card):
    """10a: two tiny float32 SPADE distill steps (teacher ngf 16, student
    ngf 8, 64x32, batch 2, KA over the three taps, VGG, spectral multiscale
    D) on the card (the Gram kernel) and on the CPU (its plain version),
    each from the card's state: the losses and the three distill parts at
    rtol 1e-4, the parameters each step writes (the student, the adaptors,
    D) within twice Adam's one-step bound at each group's TTUR rate, the
    running statistics and D's ``u``."""
    import numpy as np
    import torch

    from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                 SPADEGeneratorConfig)
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.spade_distiller import SPADEDistiller, SPADEDistillHParams
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.models.vgg import VGG19Features, random_vgg19_state_dict
    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict

    cpu = torch.device("cpu")
    kw = dict(semantic_nc=37, channels_reduction_factor=6, kernel_sizes=(1, 3, 5),
              num_upsampling_layers="normal", crop_size=64, aspect_ratio=2.0)
    tcfg = SPADEGeneratorConfig.make(ngf=16, **kw)
    scfg = SPADEGeneratorConfig.make(ngf=8, **kw)
    dcfg = MultiscaleDiscriminatorConfig(input_nc=40, ndf=16, n_layers=4, num_D=2)
    teacher = SPADEGenerator(tcfg, "xavier", generator=torch.Generator().manual_seed(10))
    vgg_sd = random_vgg19_state_dict(seed=19)

    def make(d):
        vgg = VGG19Features()
        vgg.load_state_dict(vgg_sd)
        dist = SPADEDistiller(tcfg, scfg, dcfg, SPADEDistillHParams(), vgg=vgg, input_nc=35,
                              contain_dontcare=True, device=d)
        return (dist, *dist.init_state(teacher.state_dict(), seed=10))

    rs = np.random.RandomState(10)
    gen = torch.Generator().manual_seed(10)
    batches = []
    for _ in range(2):
        label = rs.randint(0, 34, (2, 32, 64)).astype(np.float32)
        label[:, :4] = 255
        inst = np.repeat(np.repeat(rs.randint(0, 9, (2, 4, 8)), 8, 1), 8, 2).astype(np.int32)
        batches.append({"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
                        "image": torch.rand(2, 3, 32, 64, generator=gen) * 2 - 1})
    sides = [make(d) for d in (dev, cpu)]
    card_l, cpu_l = [], []
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    for b in batches:
        sd = train_state_dict(sides[0][1])
        del sd["rng"]
        load_train_state_dict(sides[1][1], sd)
        for (dist, state, tparams), ls in zip(sides, (card_l, cpu_l)):
            _, m = dist.train_step(state, tparams, {k: v.to(dist.device) for k, v in b.items()},
                                   LR)
            ls.append({k: float(v) for k, v in m.items()})
        a, c = card_l[-1], cpu_l[-1]
        if a.keys() != c.keys() or not {f"Specific_loss/distill{i}" for i in range(3)} <= set(c):
            fail(f"10a SPADE distill step {len(card_l)}: losses {sorted(a)} vs {sorted(c)}")
        for k in c:
            if not math.isclose(a[k], c[k], rel_tol=1e-4, abs_tol=1e-5):
                fail(f"10a SPADE distill step {len(card_l)}, {k}: card {a[k]!r} vs CPU {c[k]!r}")
        param_err, param_bound = {}, {}
        for net, mult in zip(("g", "d"), sides[0][0].lr_mults):
            card_p, cpu_p = ({**getattr(st, net).params,
                              **({f"A.{k}": v for k, v in st.adaptors.items()} if net == "g"
                                 else {})} for _, st, _ in sides)
            param_err[net] = max(float((v.detach().cpu() - cpu_p[k].detach()).abs().max())
                                 for k, v in card_p.items())
            opt = getattr(sides[0][1], net).opt  # TTUR's beta1 0: see city_reference
            param_bound[net] = 2 * LR * mult * math.sqrt(
                (1 - opt.beta2 ** opt.count) / (1 - opt.beta2))
            if not param_err[net] <= param_bound[net]:
                fail(f"10a SPADE distill step {len(card_l)}: {net.upper()}'s parameters differ "
                     f"from the CPU's by {param_err[net]:g}, past Adam's one-step bound "
                     f"{param_bound[net]:g}")
        card_s, cpu_s = ({f"{net}.{k}": v.cpu() for net, ns in (("G", st.g), ("D", st.d))
                          for k, v in ns.stats.items() if not k.endswith("weight_v")}
                         for _, st, _ in sides)
        err = max(float((card_s[k] - v).abs().max()) for k, v in cpu_s.items())
        if not all(torch.allclose(card_s[k], v, rtol=1e-4, atol=1e-5) for k, v in cpu_s.items()):
            fail(f"10a SPADE distill step {len(card_l)}: statistics and u differ from the CPU's "
                 f"by {err:g}")
    if ka.path_launches["f32tma"] != 12 or ka.launches != 12:
        fail(f"10a: {ka.launches} Gram launches on the card in 2 steps, "
             f"{ka.path_launches['f32tma']} of them 'f32tma'; expected 6 a step")
    n_u = sum(k.endswith("weight_u") for k in cpu_s)
    log(f"spade 10a: 2 f32 SPADE distill steps (teacher ngf 16, student ngf 8, 64x32, batch 2, "
        f"KA on {', '.join(SPADE_TAPS)}, VGG, spectral D) on the card match the CPU's, each "
        f"from the card's state: losses rtol 1e-4, parameters max |diff| G and adaptors "
        f"{param_err['g']:.3g} (bound {param_bound['g']:.3g}), D {param_err['d']:.3g} (bound "
        f"{param_bound['d']:.3g}), {len(cpu_s) - n_u} running statistics and {n_u} spectral u, "
        f"max |diff| {err:.3g}; 12 f32tma Gram launches on the card: {card_l[-1]} [{card}]")
    return {"spade_param_max_abs": param_err, "spade_stats_max_abs": err,
            "losses": card_l[-1]}


def gaugan_paths(root, judge, stats):
    """9c's data and teacher, phase 7's judge and statistics, 9b's DRN."""
    data = os.path.join(root, "gaugan-origin")
    return ["--dataroot", data, "--real_stat_path", stats,
            "--drn_path", os.path.join(root, "drn-d-105_ms_cityscapes.pth"),
            "--cityscapes_path", data, "--table_path", os.path.join(root, "table_gaugan.txt"),
            "--inception_path", judge, "--restore_teacher_G_path",
            os.path.join(root, "log_9c", "checkpoints", "latest_net_G.pth")]


def gaugan_student_argv(root, judge, stats, log_dir):
    """The 5p6B student recipe's flags over ``gaugan_paths``, with 9c's G
    as the pretrained G and 9c's D."""
    teacher = os.path.join(root, "log_9c", "checkpoints")
    return [*gaugan_paths(root, judge, stats), "--log_dir", log_dir,
            "--vgg_path", os.path.join(root, "vgg19.pth"),
            "--restore_pretrained_G_path", os.path.join(teacher, "latest_net_G.pth"),
            "--restore_D_path", os.path.join(teacher, "latest_net_D.pth"), *GAUGAN_STUDENT]


def gaugan_student(dev, card, root, judge, stats):
    """10b: ``train_inception_student_5p6B.sh``'s flags through
    ``entry.distill_main`` at full width (batch 16, 512x256, the ngf-64
    teacher of 9c as teacher and pretrained G, 9c's D, 5.6e9 MACs, KA on
    three taps, VGG, xavier, float32) for 2 epochs of 3 steps with FID and
    mIoU at the trainer's startup probe and at the end (with --remat 1 where
    batch 16 does not fit, said on a line): 6 f32tma Gram launches a step,
    the searched MACs within the budget, the checkpoints, the reloaded G's
    eval output; then the Gram on the run's own six taps.  10c: the
    evaluate recipe's profile of its best student, and --prune_only at
    3e10 MACs (the 30B recipe)."""
    import gc

    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.compress.spade import profile_spade_generator
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    log_dir = os.path.join(root, "log_10b")
    paths = gaugan_paths(root, judge, stats)

    def student_argv(log_dir):
        return gaugan_student_argv(root, judge, stats, log_dir)

    argv = student_argv(log_dir)
    n_steps = GAUGAN_STUDENT_EPOCHS * (GAUGAN_TRAIN // GAUGAN_BATCH)

    def attempt(extra):
        ka.launches = 0
        ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
        return _instrumented_run("setup_distill", entry.distill_main, [*argv, *extra], n_steps,
                                 GAUGAN_BATCH, "10b GauGAN student", card)

    oom = None
    try:
        out, run = attempt([])
    except RuntimeError as e:
        if not (isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)):
            raise
        oom = str(e).splitlines()[0]
    if oom is not None:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"spade 10b: batch {GAUGAN_BATCH} without --remat does not fit the card ({oom}); "
            "running the recipe with --remat 1")
        shutil.rmtree(log_dir, ignore_errors=True)
        out, run = attempt(["--remat", "1"])
    out["remat"] = oom is not None
    launches, on_path = ka.launches, ka.path_launches["f32tma"]
    if launches != 6 * out["steps"] or on_path != launches:
        fail(f"spade 10b: {launches} Gram launches in {out['steps']} steps, {on_path} of them "
             "'f32tma'; expected 6 a step, all 'f32tma'")
    out["gram_launches"], out["gram_path"] = launches, "f32tma"
    dist = run.distiller
    macs = profile_spade_generator(run.student_cfg, 256, 512).macs
    t_macs = profile_spade_generator(dist.teacher_cfg, 256, 512).macs
    if not macs <= 5.6e9:
        fail(f"spade 10b: the student has {macs:,} MACs, past the 5.6e9 budget")
    out["student_macs"], out["teacher_macs"] = macs, t_macs
    out["miou"], out["fid"] = _check_miou(log_dir, "10b GauGAN student", 2)
    save_dir = os.path.join(log_dir, "checkpoints")
    missing = [f for f in ("latest_net_G.pth", "latest_net_G.json", "latest_state.pth",
                           "best_net_G.pth") if not os.path.exists(os.path.join(save_dir, f))]
    if missing:
        fail(f"spade 10b: missing {missing}")
    batch = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in next(iter(run.loader)).items()}
    sd, cfg = ckpt.load_net(save_dir, "latest", "G")
    gen = SPADEGenerator(cfg).to(dev)
    gen.load_state_dict(sd)
    sem = dist.semantics(batch)
    if not _same_output(gen, lambda s: dist.generate_student(run.state, s), sem[:4]):
        fail("spade 10b: the reloaded G's eval output differs from the in-memory G's")
    log(f"spade 10b: {launches} Gram launches in {out['steps']} steps ({launches // out['steps']} "
        f"a step, f32tma); student {macs:,} MACs (teacher {t_macs:,}); G and the state written, "
        f"the reloaded G gives the in-memory G's eval output exactly; mIoU {out['miou']}, FID "
        f"{out['fid']}, remat {out['remat']} [{card}]")
    del gen, sd

    # 10b again with the branches unpacked, without evaluations: the layouts' steps side by side
    quiet = ["--no_fid", "--drn_path", os.path.join(root, "absent.pth")]
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    unpacked, _ = _instrumented_run(
        "setup_distill", entry.distill_main,
        [*student_argv(os.path.join(root, "log_10b_unpacked")), *quiet, "--packed_blocks", "0",
         *(["--remat", "1"] if out["remat"] else [])],
        n_steps, GAUGAN_BATCH, "10b GauGAN student, unpacked", card)
    if ka.path_launches["f32tma"] != 6 * n_steps:
        fail(f"spade 10b unpacked: {ka.path_launches['f32tma']} f32tma Gram launches in "
             f"{n_steps} steps; expected 6 a step")
    out["unpacked"] = unpacked
    log(f"spade 10b: median step packed {out['step_ms_median']:.1f} ms, unpacked "
        f"{unpacked['step_ms_median']:.1f} ms; peak memory {out['peak_memory_gib']:.2f} and "
        f"{unpacked['peak_memory_gib']:.2f} GiB [{card}]")
    gc.collect()
    torch.cuda.empty_cache()

    # 10d: the recipe's first epoch without --remat, then under --remat 1
    # without and with a selective policy, all with deterministic cuDNN; each
    # remat run's losses held to the run without's.  Under cuDNN's default
    # algorithms two runs of the same flags do not repeat bit for bit: their
    # step-1 losses agree and the gap grows from step 2 on (6.4e-7 to 1.6e-4
    # at step 3 over four calls), whatever remat does.  Deterministic cuDNN
    # repeats them, with remat too.  10b's own gap (default algorithms) to
    # the run without is printed beside.
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        first_10b = [{k: v for k, v in r.items() if "loss" in k}
                     for r in map(json.loads, f) if any("loss" in k for k in r)][:REMAT_STEPS]

    def losses_of(d):
        with open(os.path.join(d, "scalars.jsonl")) as f:
            return [{k: v for k, v in row.items() if "loss" in k}
                    for row in map(json.loads, f) if any("loss" in k for k in row)]

    def worst_gap(got, want):
        return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-1) for g, w in zip(got, want) for k in w)

    remat = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = None
        for remat_flags in ([], ["--remat", "1"],
                            ["--remat", "1", "--remat_policy", "dots_saveable"]):
            policy = remat_flags[3] if len(remat_flags) > 2 else ""
            name = "reference" if not remat_flags else policy or "none"
            what = " ".join(remat_flags) or "no --remat"
            gc.collect()
            torch.cuda.empty_cache()
            ka.launches = 0
            ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
            d = os.path.join(root, f"log_10d_{name}")
            r, _ = _instrumented_run(
                "setup_distill", entry.distill_main,
                [*student_argv(d), *quiet, "--nepochs", "1", *remat_flags],
                REMAT_STEPS, GAUGAN_BATCH, f"10d GauGAN student, {what}", card)
            got = losses_of(d)
            if ka.path_launches["f32tma"] != 6 * REMAT_STEPS:
                fail(f"spade 10d ({what}): {ka.path_launches['f32tma']} f32tma Gram "
                     f"launches in {REMAT_STEPS} steps; expected 6 a step")
            if want is None:
                want = got
                gap_10b = worst_gap(first_10b, want)
                remat["reference"] = {"step_ms_median": r["step_ms_median"],
                                      "peak_memory_gib": r["peak_memory_gib"],
                                      "loss_worst_rel_10b": gap_10b}
                log(f"spade 10d: reference (no --remat, deterministic cuDNN): median step "
                    f"{r['step_ms_median']:.1f} ms, peak memory {r['peak_memory_gib']:.2f} GiB; "
                    f"10b's first {REMAT_STEPS} steps (cuDNN's default algorithms) differ from "
                    f"it by {gap_10b:.2g} at worst [{card}]")
                continue
            worst = worst_gap(got, want)
            if (len(got) != REMAT_STEPS or any(g.keys() != w.keys() for g, w in zip(got, want))
                    or not all(math.isclose(g[k], w[k], rel_tol=1e-4, abs_tol=1e-5)
                               for g, w in zip(got, want) for k in w)):
                fail(f"spade 10d ({what}): losses {got} differ from the run without --remat's "
                     f"{want} past 10a's bound (rtol 1e-4, atol 1e-5)")
            remat[name] = {"step_ms_median": r["step_ms_median"],
                           "peak_memory_gib": r["peak_memory_gib"],
                           "f32tma_per_step": ka.path_launches["f32tma"] / REMAT_STEPS,
                           "loss_worst_rel": worst,
                           "bit_identical": got == want}
            log(f"spade 10d: {what}: median step {r['step_ms_median']:.1f} ms, peak memory "
                f"{r['peak_memory_gib']:.2f} GiB, {ka.path_launches['f32tma'] / REMAT_STEPS:g} "
                f"f32tma launches a step; losses of its {REMAT_STEPS} steps within rtol 1e-4 of "
                f"the run without --remat's (worst {worst:.2g}, bit-identical {got == want}) "
                f"[{card}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    out["remat_10d"] = remat

    # the Gram on the run's own taps: teacher and student, three taps each
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        taps = [acts[name].reshape(sem.shape[0], -1).contiguous()
                for net in (dist.netG_teacher, dist.netG_student)
                for acts in [net(sem, taps=SPADE_TAPS)[1]] for name in SPADE_TAPS]
    names = [f"{who} {name}" for who in ("teacher", "student") for name in SPADE_TAPS]
    kern = gram_numbers(taps, l2.zero_, card, "f32tma", names=names, per_step=1)
    kern["b"], kern["f"] = sem.shape[0], [x.shape[1] for x in taps]
    del taps, l2, run, dist, batch, sem
    gc.collect()
    torch.cuda.empty_cache()

    # 10c: the evaluate recipe's profile of the best student, and the 30B
    # recipe's shrink alone
    timers = _EvalTimers()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prof = entry.profile_main([*paths, "--log_dir", os.path.join(root, "eval_10c"),
                                   "--pretrained_student_G_path",
                                   os.path.join(save_dir, "best_net_G.pth"),
                                   *GAUGAN_STUDENT_EVAL])
        prof_s = time.perf_counter() - t0
    finally:
        secs = timers.restore()
    m = prof["metrics"]
    if not (0.0 <= m.get("metric/mIoU", -1.0) <= 100.0 and math.isfinite(m["metric/fid"])
            and prof["student_macs"] == macs):
        fail(f"spade 10c profile: metrics {m}, student MACs {prof['student_macs']:,} "
             f"(trained {macs:,})")
    log(f"spade 10c profile: student {prof['student_macs']:,} MACs, "
        f"{prof['student_params']:,} parameters, shrink {prof['pruning_seconds_mean'] * 1e3:.2f} "
        f"ms (mean of 10), latency {prof['latency_ms']:.3f} ms/image at batch 1, FID "
        f"{m['metric/fid']:.4f}, mIoU {m['metric/mIoU']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {prof_s:.1f} s in all; evaluation "
        f"{_EvalTimers.line(secs)} [{card}]")
    p30 = os.path.join(root, "log_10c_30B")
    t0 = time.perf_counter()
    run30 = entry.distill_main([*argv, "--log_dir", p30, "--target_flops", "3e10",
                                "--prune_only"])
    macs30 = profile_spade_generator(run30.student_cfg, 256, 512).macs
    if run30.trainer is not None or not macs30 <= 3e10 or not os.path.exists(
            os.path.join(p30, "student_config.json")):
        fail(f"spade 10c --prune_only at 3e10: student {macs30:,} MACs, trainer "
             f"{run30.trainer is not None}")
    log(f"spade 10c: --prune_only at 3e10 wrote the student config, {macs30:,} MACs, in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    out["profile"] = {"metrics": m, "seconds": prof_s, "eval": secs,
                      "latency_ms": prof["latency_ms"],
                      "pruning_ms_mean": prof["pruning_seconds_mean"] * 1e3,
                      "student_params": prof["student_params"]}
    out["macs_30B"] = macs30
    return out, kern


# ---------------------------------------------------------------------------
# Phase 11: export
# ---------------------------------------------------------------------------

# scripts/cycle_gan/horse2zebra/export_inception_student_2p6B.sh and
# scripts/gaugan/cityscapes/export_inception_student_5p6B.sh, but for the paths
H2Z_EXPORT = ["--dataset_mode", "unaligned", "--export_format", "stablehlo"]
GAUGAN_EXPORT = ["--distiller", "spade", "--dataset_mode", "cityscapes", "--input_nc", "35",
                 "--contain_dontcare_label", "--preprocess", "scale_width", "--load_size", "512",
                 "--crop_size", "512", "--aspect_ratio", "2", "--export_format", "stablehlo"]
LATENCY_REPS = 100  # the profile verb's --times


def export_students(dev, card, root, gaugan_profile_ms):
    """11: the export verb with both recipes' flags, on phase 6 (a)'s student
    and on 10b's best; each ``.pt2`` loaded on the card and run at batch 1
    and 4 against the eager eval-mode student (float32, TF32 off: rtol
    1e-4, atol 1e-5 of the output's largest value), and its batch-1 latency
    (the profile verb's way: 100 calls, host clock, synchronised) beside the
    profile verb's for the same student (phase 6's profiled here on 2 val
    images, 10b's from 10c)."""
    import numpy as np
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.export import load_program
    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.train.spade_model import preprocess_input
    from cat_tpu_torch.utils import checkpoint as ckpt

    teacher = os.path.join(root, "teacher", "best_A_net_G_A.pth")
    h2z_dir = os.path.join(root, "log_a", "checkpoints")
    prof = entry.profile_main(["--dataroot", os.path.join(root, "data"), "--log_dir",
                               os.path.join(root, "eval_11"), "--restore_teacher_G_path", teacher,
                               "--pretrained_student_G_path",
                               os.path.join(h2z_dir, "latest_net_G.pth"), "--num_test", "2",
                               *EVAL_RECIPE])
    gaugan_dir = os.path.join(root, "log_10b", "checkpoints")
    rs = np.random.RandomState(11)

    def h2z_input(b):
        return torch.from_numpy(rs.uniform(-1, 1, (b, 3, SIZE, SIZE)).astype(np.float32)).to(dev)

    def gaugan_input(b):
        label = torch.from_numpy(rs.randint(0, 35, (b, 256, 512)).astype(np.float32))
        inst = torch.from_numpy(np.repeat(np.repeat(rs.randint(0, 9, (b, 32, 64)), 8, 1), 8, 2))
        return preprocess_input(label.to(dev), inst.to(dev), 35, True)

    runs = (("horse2zebra 2p6B", ["--dataroot", os.path.join(root, "data"),
                                  "--restore_teacher_G_path", teacher, *H2Z_EXPORT], h2z_dir,
             "latest", h2z_input, prof["latency_ms"]),
            ("GauGAN 5p6B", ["--dataroot", os.path.join(root, "gaugan-origin"),
                             "--restore_teacher_G_path", os.path.join(gaugan_dir, "best_net_G.pth"),
                             *GAUGAN_EXPORT], gaugan_dir, "best", gaugan_input, gaugan_profile_ms))
    out = {}
    for label, flags, ckpt_dir, tag, make_input, prof_ms in runs:
        log_dir = os.path.join(root, f"export_{tag}_{len(out)}")
        t0 = time.perf_counter()
        path = entry.export_main([*flags, "--log_dir", log_dir, "--pretrained_student_G_path",
                                  os.path.join(ckpt_dir, f"{tag}_net_G.pth")])
        export_s = time.perf_counter() - t0
        if path != os.path.join(log_dir, "student.pt2"):
            fail(f"export 11 ({label}): wrote {path}")
        torch.cuda.empty_cache()
        program = load_program(path)
        sd, cfg = ckpt.load_net(ckpt_dir, tag, "G")
        net = (SPADEGenerator(cfg) if "GauGAN" in label else
               InceptionGenerator(cfg, packed_blocks=True)).to(dev).eval()
        net.load_state_dict(sd)
        errs, mem = {}, {}
        for b in (1, 4):
            x = make_input(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                got = program(x)
                torch.cuda.synchronize()
                mem[b] = torch.cuda.max_memory_allocated() / 2 ** 30
                want = net(x)
            scale = float(want.abs().max())
            errs[b] = float((got - want).abs().max())
            if (got.shape != (b, 3, *x.shape[2:]) or got.device != x.device
                    or not bool(torch.isfinite(got).all())
                    or not torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)):
                fail(f"export 11 ({label}): batch {b} program output {tuple(got.shape)} on "
                     f"{got.device} differs from the eager student by {errs[b]:g} (max |y| "
                     f"{scale:g}; rtol 1e-4, atol 1e-5 of it)")
        x = make_input(1)
        with torch.no_grad():
            program(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LATENCY_REPS):
                program(x)
            torch.cuda.synchronize()
        latency = (time.perf_counter() - t0) / LATENCY_REPS * 1e3
        out[label] = {"export_s": export_s, "bytes": os.path.getsize(path), "max_abs_err": errs,
                      "latency_ms": latency, "profile_latency_ms": prof_ms,
                      "peak_memory_gib": mem}
        log(f"export 11 ({label}): {path} written in {export_s:.1f} s ({os.path.getsize(path):,} "
            f"bytes); loaded on the card, batch 1 and 4 match the eager student (max |diff| "
            f"{errs[1]:.3g}, {errs[4]:.3g}); batch-1 latency {latency:.3f} ms/image (the profile "
            f"verb's {prof_ms:.3f}); peak memory {mem[1]:.2f} GiB at batch 1, {mem[4]:.2f} at 4 "
            f"[{card}]")
        del program, net
    return out


# ---------------------------------------------------------------------------
# Phase 12: data parallelism
# ---------------------------------------------------------------------------

DP_EPOCHS = 2  # 12 (a), (b): 4 steps of phase 6's recipe at batch 80
DP_SPADE_STEPS = 3  # 12 (c): the GauGAN student recipe's first epoch at batch 16
DP_TIMEOUT = 420  # the spawned ranks' seconds, CUDA start-up and kernel loads included
# 12 (b), (c) against one process: |loss - loss_1| <= DP_LOSS_TOL * max(|loss_1|, 0.1).
# The two ranks sum their halves of a batch where one process sums the batch
# once, and Adam turns the last bits of a near-zero gradient into a step of
# ±lr (2e-4; D 4e-4 under TTUR): on the CPU one such step moved the SPADE
# distiller's hinge G loss of -0.0317 by 3.5e-5 (tests/test_torch_parallel.py).
DP_LOSS_TOL = 1e-3
GLOO_PROBE = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single", "reduce", "gather", "scatter")


def _scalars(log_dir, key="loss"):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [{k: v for k, v in r.items() if key in k}
                for r in map(json.loads, f) if any(key in k for k in r)]


def _loss_gap(got, want, scale=0.1):
    """The worst |g - w| / max(|w|, scale) over every step and loss; inf when
    the steps or their losses do not match."""
    if len(got) != len(want) or any(g.keys() != w.keys() for g, w in zip(got, want)):
        return math.inf
    return max(abs(g[k] - w[k]) / max(abs(w[k]), scale) for g, w in zip(got, want) for k in w)


class _DPCounts:
    """Gram launches of this process by path and the rows of each Gram
    operand, and the row gathers with their shapes, from zero."""

    def __init__(self):
        from cat_tpu_torch.distill import ka
        from cat_tpu_torch.parallel import collectives

        self.ka, self.collectives = ka, collectives
        ka.launches = 0
        ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
        self.rows, self.gathers = [], []
        self._gram, self._gather = ka.gram, collectives.all_gather_rows

        def gram(x):
            self.rows.append(int(x.shape[0]))
            return self._gram(x)

        def gather(x):
            if collectives.active():
                self.gathers.append((tuple(x.shape), str(x.dtype)))
            return self._gather(x)

        ka.gram, collectives.all_gather_rows = gram, gather

    def restore(self):
        self.ka.gram, self.collectives.all_gather_rows = self._gram, self._gather
        return {"gram": self.ka.launches, **{f"gram_{k}": v
                                             for k, v in self.ka.path_launches.items() if v},
                "gram_rows": sorted(set(self.rows)), "gathers": len(self.gathers)}


def dp_verb_argv(root, log_dir):
    """Phase 6's recipe for DP_EPOCHS epochs over its data, teacher and D."""
    teacher = os.path.join(root, "teacher")
    return ["--dataroot", os.path.join(root, "data"), "--log_dir", log_dir,
            "--restore_teacher_G_path", os.path.join(teacher, "best_A_net_G_A.pth"),
            "--restore_pretrained_G_path", os.path.join(teacher, "best_A_net_G_A.pth"),
            "--restore_D_path", os.path.join(teacher, "best_A_net_D_A.pth"),
            *RECIPE, "--nepochs", str(DP_EPOCHS), "--save_epoch_freq", str(DP_EPOCHS)]


def dp_world1(card, root):
    """12 (a): the recipe in one process with no group, twice, then in an
    NCCL group of one rank on cuda:0 that the verb joins (``initialize`` is
    idempotent), all with deterministic cuDNN.  Step 1's losses within 1e-6
    relative of one process's: its forwards, and the D update the G loss
    reads, are deterministic.  Later steps follow G updates whose backward
    sums with atomics (the reflection pads'), which two one-process runs
    already do not repeat bit for bit: held to phase 10d's bound (rtol
    1e-4, atol 1e-5), the one-process runs' own gap printed beside.  8
    f32tma Gram launches a step on 80 rows in every run, and the
    collectives' route taken in the group (8 row gathers a step)."""
    import torch
    import torch.distributed as dist

    from cat_tpu_torch import entry
    from cat_tpu_torch.parallel import mesh

    n_steps = DP_EPOCHS * VERB_IMAGES // VERB_BATCH
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for label in ("plain", "plain_again", "nccl"):
            if label == "nccl":
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{mesh.free_port()}",
                                        world_size=1, rank=0, device_id=torch.device("cuda", 0))
            counts = _DPCounts()
            try:
                t0 = time.perf_counter()
                entry.distill_main(dp_verb_argv(root, os.path.join(root, f"log_12a_{label}")))
                wall = time.perf_counter() - t0
            finally:
                c = counts.restore()
                if label == "nccl":
                    dist.destroy_process_group()
            gathers_expected = 8 * n_steps if label == "nccl" else 0
            if (c["gram"] != 8 * n_steps or c.get("gram_f32tma") != c["gram"]
                    or c["gram_rows"] != [VERB_BATCH] or c["gathers"] != gathers_expected):
                fail(f"12 (a) {label}: {c}; expected {8 * n_steps} f32tma Gram launches on "
                     f"{VERB_BATCH} rows and {gathers_expected} row gathers")
            out[label] = {"losses": _scalars(os.path.join(root, f"log_12a_{label}")),
                          "counts": c, "wall_s": wall}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, nccl = out["plain"]["losses"], out["nccl"]["losses"]
    first = _loss_gap(nccl[:1], plain[:1], scale=1e-30)
    later = _loss_gap(nccl, plain, scale=1e-30)
    spread = _loss_gap(out["plain_again"]["losses"], plain, scale=1e-30)
    if (len(plain) != n_steps or not first <= 1e-6 or len(nccl) != n_steps
            or not all(math.isclose(g[k], w[k], rel_tol=1e-4, abs_tol=1e-5)
                       for g, w in zip(nccl, plain) for k in w)):
        fail(f"12 (a): the NCCL world of one's losses {nccl} against one process's {plain}: "
             f"step 1 within {first:.3g} relative (bound 1e-6), all steps {later:.3g} (bound "
             f"rtol 1e-4, atol 1e-5)")
    log(f"12 (a): {n_steps} steps in one process (twice) and in an NCCL group of one rank: "
        f"step 1's losses within {first:.3g} relative (bound 1e-6), every step's within "
        f"{later:.3g} (bound rtol 1e-4, atol 1e-5); one process against itself {spread:.3g}; "
        f"{out['nccl']['counts']} [{card}]")
    return {"step1_gap": first, "loss_gap": later, "plain_spread": spread,
            "counts": out["nccl"]["counts"], "losses": plain,
            "wall_s": {k: v["wall_s"] for k, v in out.items()}}


def _dp_spade_eval(root, judge, stats, label, process_shard=None, log_dir="log_12c_w1"):
    """One FID + mIoU evaluation of the student ``root/log_dir`` holds (12
    (c)'s one-process student by default) through the evaluators the SPADE
    verbs build; the merged confusion matrix that the mIoU was taken from.
    ``process_shard`` as the verb passes it."""
    import numpy as np
    import torch

    from cat_tpu_torch import cli, entry
    from cat_tpu_torch.metrics import drn
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.train.spade_model import preprocess_input
    from cat_tpu_torch.utils import checkpoint as ckpt

    parser = cli.distill_parser()
    opt = parser.parse_args(gaugan_student_argv(root, judge, stats,
                                                os.path.join(root, f"log_12c_eval_{label}")))
    cli.apply_distill_defaults(opt, parser)
    dev = torch.device("cuda", torch.cuda.current_device())
    sd, cfg = ckpt.load_net(os.path.join(root, log_dir, "checkpoints"), "latest", "G")
    gen = SPADEGenerator(cfg).to(dev)
    gen.load_state_dict(sd)

    @torch.no_grad()
    def generate(b):
        return gen(preprocess_input(b["label"], b.get("instance"), opt.input_nc,
                                    opt.contain_dontcare_label))

    primary = process_shard is None or process_shard[0] == 0
    evaluate = entry._spade_evaluators(opt, generate, dev, primary=primary,
                                       process_shard=process_shard)
    hists, mean_iou = [], drn.mean_iou
    drn.mean_iou = lambda h: hists.append(np.asarray(h)) or mean_iou(h)
    try:
        t0 = time.perf_counter()
        metrics, _ = evaluate(None, "12c")
        secs = time.perf_counter() - t0
    finally:
        drn.mean_iou = mean_iou
    return {"fid": metrics["metric/fid"], "miou": metrics["metric/mIoU"],
            "hist": hists[-1].tolist(), "seconds": secs}


def dp_rank_b(device, root):
    """12 (b) on this rank: phase 6's recipe at global batch 80, its steps
    timed, its Gram operands' rows counted, then its row gathers timed
    alone at the run's shapes."""
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.parallel import collectives

    steps, starts, waits = [], [], []
    setup = entry.setup_distill
    entry.setup_distill = _instrumented(setup, steps, starts, waits)
    counts = _DPCounts()
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        entry.distill_main(dp_verb_argv(root, os.path.join(root, "log_12b")), device=device)
        wall = time.perf_counter() - t0
    finally:
        entry.setup_distill = setup
        c = counts.restore()
    mem = torch.cuda.max_memory_allocated(device)
    shapes = counts.gathers[:8]  # one step's: four taps, teacher and student
    per_step = []
    for _ in range(3):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for shape, dtype in shapes:
            collectives.all_gather_rows(torch.ones(shape, dtype=getattr(torch, dtype[6:]),
                                                   device=device))
        torch.cuda.synchronize(device)
        per_step.append(time.perf_counter() - t0)
    torch.cuda.empty_cache()
    return {**_loop_numbers(steps, starts, waits, VERB_BATCH // 2, mem, wall), "counts": c,
            "gather_shapes": [list(s) for s, _ in shapes],
            "gather_ms_per_step": [1e3 * t for t in per_step],
            "gathered_bytes_per_step": sum(2 * math.prod(s) * 4 for s, _ in shapes)}


def dp_rank_c(device, root, judge, stats, rank):
    """12 (c) on this rank: the GauGAN student recipe's first epoch at
    global batch 16, then one evaluation of (c)'s one-process student."""
    import torch

    from cat_tpu_torch import entry

    counts = _DPCounts()
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        entry.distill_main([*gaugan_student_argv(root, judge, stats,
                                                 os.path.join(root, "log_12c_w2")),
                            "--no_fid", "--drn_path", os.path.join(root, "absent.pth"),
                            "--nepochs", "1"], device=device)
        wall = time.perf_counter() - t0
    finally:
        c = counts.restore()
    out = {"counts": c, "wall_s": wall,
           "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
           "eval": _dp_spade_eval(root, judge, stats, "w2", (rank, 2))}
    torch.cuda.empty_cache()
    return out


def gloo_cuda_probe(device, rank):
    """Which collectives gloo serves for CUDA tensors: a refusal is a
    finding, not a failure (the path uses all_reduce, broadcast and
    all_gather).  A group with a timeout, so that a stall ends."""
    import datetime

    import torch
    import torch.distributed as dist

    probe = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x, group=probe),
        "broadcast": lambda: dist.broadcast(x, 0, group=probe),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                                              group=probe),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device=device), x, group=probe),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=device), x, group=probe),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x, group=probe),
        "reduce": lambda: dist.reduce(x, 0, group=probe),
        "gather": lambda: dist.gather(x, [torch.empty_like(x) for _ in range(2)] if rank == 0
                                      else None, 0, group=probe),
        "scatter": lambda: dist.scatter(x, [torch.ones_like(x) for _ in range(2)] if rank == 0
                                        else None, 0, group=probe),
    }
    served = {}
    for name in GLOO_PROBE:
        try:
            calls[name]()
            torch.cuda.synchronize(device)
            served[name] = "served"
        except Exception as e:  # what gloo refuses for CUDA tensors
            served[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return served


def _dp_rank(device, root, judge, stats):
    """A rank of 12 (b) and (c), sharing cuda:0 with the other over gloo;
    writes ``dp_rank<r>.json`` under ``root`` after each part."""
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out = {"rank": rank, "device": str(device)}
    path = os.path.join(root, f"dp_rank{rank}.json")
    for part, fn in (("b", lambda: dp_rank_b(device, root)),
                     ("c", lambda: dp_rank_c(device, root, judge, stats, rank)),
                     ("gloo_cuda", lambda: gloo_cuda_probe(device, rank))):
        out[part] = fn()
        with open(path, "w") as f:
            json.dump(out, f)


def data_parallel(card, root, judge, stats):
    """Phase 12: (a) the world of one; (c)'s one-process run and
    evaluation; (b) and (c) over two gloo ranks on cuda:0 (NCCL refuses two
    ranks on one device), held to one process.  Two ranks on one card:
    not a scaling measurement."""
    import gc

    import numpy as np
    import torch

    from cat_tpu_torch import entry
    from cat_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    a = dp_world1(card, root)

    # (c) in one process: its steps, then one evaluation of its student
    quiet = ["--no_fid", "--drn_path", os.path.join(root, "absent.pth"), "--nepochs", "1"]
    counts = _DPCounts()
    try:
        c1, _ = _instrumented_run("setup_distill", entry.distill_main,
                                  [*gaugan_student_argv(root, judge, stats,
                                                        os.path.join(root, "log_12c_w1")),
                                   *quiet], DP_SPADE_STEPS, GAUGAN_BATCH,
                                  "12 (c) GauGAN student, one process", card)
    finally:
        c1_counts = counts.restore()
    ev1 = _dp_spade_eval(root, judge, stats, "w1")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) and (c) over two ranks
    t0 = time.perf_counter()
    mesh.spawn(_dp_rank, 2, args=(root, judge, stats), device="cuda:0", backend="gloo",
               timeout=DP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in (0, 1):
        with open(os.path.join(root, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))

    n_steps = DP_EPOCHS * VERB_IMAGES // VERB_BATCH
    b_losses = _scalars(os.path.join(root, "log_12b"))
    b_gap = _loss_gap(b_losses, a["losses"])
    c_gap = _loss_gap(_scalars(os.path.join(root, "log_12c_w2")),
                      _scalars(os.path.join(root, "log_12c_w1")))
    for rk in ranks:
        b, c = rk["b"]["counts"], rk["c"]["counts"]
        if (rk["b"]["steps"] != n_steps or b["gram"] != 8 * n_steps
                or b.get("gram_f32tma") != b["gram"] or b["gram_rows"] != [VERB_BATCH]
                or b["gathers"] != 8 * n_steps):
            fail(f"12 (b) rank {rk['rank']}: {rk['b']['steps']} steps, {b}; expected {n_steps} "
                 f"steps, 8 f32tma Gram launches a step on the {VERB_BATCH} gathered rows")
        if (c["gram"] != 6 * DP_SPADE_STEPS or c.get("gram_f32tma") != c["gram"]
                or c["gram_rows"] != [GAUGAN_BATCH]):
            fail(f"12 (c) rank {rk['rank']}: {c}; expected 6 f32tma Gram launches a step on "
                 f"the {GAUGAN_BATCH} gathered rows")
        e, w = rk["c"]["eval"], ev1
        if not (abs(e["fid"] - w["fid"]) <= 1e-3 * abs(w["fid"]) and e["hist"] == w["hist"]
                and e["miou"] == w["miou"]):
            fail(f"12 (c) rank {rk['rank']}: the evaluation over two ranks (FID {e['fid']}, "
                 f"mIoU {e['miou']}) differs from one process's (FID {w['fid']}, mIoU "
                 f"{w['miou']}) or its confusion matrix does")
    if not (b_gap <= DP_LOSS_TOL and c_gap <= DP_LOSS_TOL):
        fail(f"12 (b), (c): losses over two ranks against one process: worst gaps {b_gap:.3g} "
             f"and {c_gap:.3g} of max(|loss|, 0.1) (bound {DP_LOSS_TOL})")
    if c1_counts["gram"] != 6 * DP_SPADE_STEPS:
        fail(f"12 (c) one process: {c1_counts}")
    refused = {k: v for k, v in ranks[0]["gloo_cuda"].items() if v != "served"}
    b0 = ranks[0]["b"]
    log(f"12 (b): two gloo ranks on cuda:0 (not a scaling measurement), global batch "
        f"{VERB_BATCH}: losses within {b_gap:.3g} of max(|loss|, 0.1) of one process's; per rank "
        + "; ".join(f"rank {rk['rank']}: median step {rk['b']['step_ms_median']:.1f} ms, row "
                    f"gathers {np.median(rk['b']['gather_ms_per_step']):.1f} ms a step alone "
                    f"({rk['b']['gathered_bytes_per_step'] / 2**20:.0f} MiB), peak memory "
                    f"{rk['b']['peak_memory_gib']:.2f} GiB, {rk['b']['counts']}" for rk in ranks)
        + f" [{card}]")
    log(f"12 (c): GauGAN student at global batch {GAUGAN_BATCH}, {DP_SPADE_STEPS} steps: losses "
        f"within {c_gap:.3g} of max(|loss|, 0.1) of one process's (median step "
        f"{c1['step_ms_median']:.1f} ms there); one evaluation over two ranks: FID "
        f"{ranks[0]['c']['eval']['fid']:.6f} against {ev1['fid']:.6f}, mIoU "
        f"{ranks[0]['c']['eval']['miou']} against {ev1['miou']}, confusion matrices equal; "
        f"{ranks[0]['c']['eval']['seconds']:.1f} s and {ev1['seconds']:.1f} s [{card}]")
    log(f"12: gloo for CUDA tensors serves "
        f"{[k for k, v in ranks[0]['gloo_cuda'].items() if v == 'served']}, refuses {refused}")
    return {"a": a, "b": {"loss_gap": b_gap, "ranks": [rk["b"] for rk in ranks]},
            "c": {"loss_gap": c_gap, "one_process": {**c1, "counts": c1_counts},
                  "ranks": [rk["c"] for rk in ranks], "eval_one_process": ev1},
            "gloo_cuda": ranks[0]["gloo_cuda"], "spawn_s": spawn_s,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# Phase 13: spatial parallelism (image height split over ranks)
# ---------------------------------------------------------------------------

SP_TIMEOUT = 420  # the spawned ranks' seconds, CUDA start-up included
SP_TASKS = ("distill", "pix2pix", "cyclegan")
SP_ALPHA = (0.3, 0.8, 0.55, 0.1)  # 13 (a)'s fixed penalty weights, global batch 4
SP_BATCH = 4
SP_WORLDS = ((2, 2), (4, 2))  # (ranks, spatial ranks): 1 x 2 and 2 x 2


def sp_shard(x, rank, n_spatial, world):
    """Rank ``rank``'s part of a whole NCHW batch: its data index's rows and
    its spatial index's height rows (``parallel/spatial.py::rows``)."""
    from cat_tpu_torch.parallel.spatial import rows

    d, s = divmod(rank, n_spatial)
    b = x.shape[0] // (world // n_spatial)
    start, stop = rows(x.shape[2], s, n_spatial)
    return x[d * b:(d + 1) * b, :, start:stop]


def sp_cfgs(kind, ngf, d_in):
    """13 (a)'s tiny (generator, discriminator) configs: ``kind`` norms."""
    from cat_tpu_torch.core.config import (InceptionGeneratorConfig, NLayerDiscriminatorConfig,
                                           NormConfig)

    norm = NormConfig(kind=kind, affine=True, track_running_stats=kind == "batch")
    return (InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                          kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm),
            NLayerDiscriminatorConfig(input_nc=d_in, ndf=8, norm=norm))


def sp_tiny(name, dev, fused=False, keep=None):
    """13 (a)'s tiny float32 task ``name`` on ``dev`` from seeds: (step
    function of a batch -> metrics, train state).  The distiller: instance
    norm, lsgan, KA on two taps (``fused``: its instance norms through the
    norm kernel); pix2pix: tracked batch norm, wgangp; CycleGAN: instance
    norm, lsgan, a pool of 3.  ``keep``: a dict that receives the task."""
    import torch

    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator
    from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask
    from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask

    if name == "distill":
        (tc, dc), (sc, _) = sp_cfgs("instance", 8, 3), sp_cfgs("instance", 4, 3)
        teacher = InceptionGenerator(tc, generator=torch.Generator().manual_seed(1))
        hp = DistillHParams(dataset_mode="unaligned", gan_mode="lsgan", lambda_recon=5.0,
                            mapping_layers=("encode", "block1"), fused_norms=fused)
        task = InceptionDistiller(tc, sc, dc, hp, dev)
        state, tparams = task.init_state(teacher.state_dict(), seed=3)
        if keep is not None:
            keep["task"] = task
        return (lambda b: task.train_step(state, tparams, b, LR)[1]), state
    if name == "pix2pix":
        task = Pix2PixTask(*sp_cfgs("batch", 8, 6), Pix2PixHParams(gan_mode="wgangp"), dev)
        state = task.init_state(3)
    else:
        task = CycleGANTask(*sp_cfgs("instance", 8, 3), CycleGANHParams(pool_size=3), dev)
        state = task.init_state(32, 32, 3)
    return (lambda b: task.train_step(state, b, LR)[1]), state


def sp_batches():
    import torch

    gen = torch.Generator().manual_seed(4)
    return [{k: torch.randn(SP_BATCH, 3, 32, 32, generator=gen) for k in "AB"} for _ in range(2)]


def _sp_fixed_alpha():
    """Fix the mixed penalty's weights (the global batch's, each rank keeping
    its rows); returns the undo."""
    import torch

    from cat_tpu_torch.models import losses
    from cat_tpu_torch.parallel import collectives

    mixing = losses.mixing_weights
    losses.mixing_weights = lambda n, generator, like: collectives.local_rows(torch.tensor(
        SP_ALPHA, dtype=like.dtype, device=like.device).reshape(-1, 1, 1, 1))

    def undo():
        losses.mixing_weights = mixing

    return undo


def _sp_counts_reset():
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.ops import instance_norm as inorm

    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    inorm.launches = 0
    inorm.split_launches.update(dict.fromkeys(inorm.split_launches, 0))


def _sp_counts():
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.ops import instance_norm as inorm

    return {"gram": ka.launches, **{f"gram_{k}": v for k, v in ka.path_launches.items() if v},
            "instance_norm_act": inorm.launches,
            **{f"split_{k}": v for k, v in inorm.split_launches.items()}}


def sp_tiny_runs(dev, root, tasks, rank=0, n_spatial=1, world=1, make=None, batches=None,
                 part=None, phase="13a", keep_u=False):
    """Each tiny task's two steps on this process's part of the batches
    (``make``, ``batches`` and ``part``: 13 (a)'s ``sp_tiny``,
    ``sp_batches`` and ``sp_shard`` by default).  Step 2 starts from the
    one-process state after step 1 (``root``'s ``<phase>_<task>.pt``; the
    one process writes it), so that Adam's ±lr on float32-noise gradients
    does not compound (phase 8a's rule); a split world's rank 0 keeps its
    own state after step 1 beside it (``..._w<world>.pt``, for the
    diagnosis).  The launches of each task's steps are counted from zero,
    and the Gram operands' shapes recorded; ``keep_u``: D's spectral ``u``
    after the steps too."""
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.train.common import load_train_state_dict, train_state_dict

    make = make or sp_tiny
    batches = sp_batches() if batches is None else batches
    part = part or (lambda b, *a: {k: sp_shard(v, *a) for k, v in b.items()})
    out = {}
    gram = ka.gram
    for name in tasks:
        step, state = make(name.split("_")[0], dev, fused=name.endswith("fused"))
        _sp_counts_reset()
        losses, shapes = [], []
        ka.gram = lambda x: shapes.append(list(x.shape)) or gram(x)
        try:
            for i, b in enumerate(batches):
                if i == 1:
                    path = os.path.join(root, f"{phase}_{name}.pt")
                    if world == 1:
                        torch.save(train_state_dict(state), path)
                    elif rank == 0:
                        torch.save(train_state_dict(state), path[:-3] + f"_w{world}.pt")
                    load_train_state_dict(state, torch.load(path, map_location="cpu",
                                                            weights_only=False))
                m = step({k: v.to(dev) for k, v in part(b, rank, n_spatial, world).items()})
                losses.append({k: float(v) for k, v in m.items()})
        finally:
            ka.gram = gram
        torch.cuda.synchronize(dev)
        out[name] = {"losses": losses, "counts": _sp_counts(), "gram_shapes": shapes}
        if keep_u:
            out[name]["d_u"] = {k: v.cpu().tolist() for k, v in state.d.stats.items()
                                if k.endswith("weight_u")}
    return out


def sp_rank_a(device, root, n_spatial):
    """13 (a) and (e) on one rank of a ``(data, spatial)`` world sharing
    cuda:0; writes ``sp_a<world>_<rank>.json``."""
    import torch
    import torch.distributed as dist

    from cat_tpu_torch.parallel import collectives

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    collectives.set_layout(n_spatial)
    rank, world = dist.get_rank(), dist.get_world_size()
    tasks = SP_TASKS + (("distill_fused",) if world == n_spatial else ())
    undo = _sp_fixed_alpha()
    try:
        out = sp_tiny_runs(device, root, tasks, rank, n_spatial, world)
    finally:
        undo()
    if world == n_spatial:  # the diagnosis: D's layers over the split height
        layers = sp_d_layers(device, sp_shard(sp_batches()[0]["B"], rank, n_spatial, world))
        if rank == 0:
            torch.save(layers, os.path.join(root, "13a_d_layers_split.pt"))
    out["spade"] = sp_spade_runs(device, root, rank, n_spatial, world)  # 13 (e)
    with open(os.path.join(root, f"sp_a{world}_{rank}.json"), "w") as f:
        json.dump(out, f)


def sp_d_layers(dev, x, d_state=None):
    """13 (a)'s distiller's D (its seeded start, or the parameters of
    ``d_state``, a train state's ``"d"``) in train mode, statistics left
    alone, on ``x`` (this rank's rows of an image batch): each conv's
    output, joined to full height over the spatial axis, on the CPU."""
    import torch

    from cat_tpu_torch.models import discriminators
    from cat_tpu_torch.ops.nn import frozen_stats
    from cat_tpu_torch.parallel import collectives, spatial

    keep = {}
    sp_tiny("distill", dev, keep=keep)
    net = keep["task"].netD
    if d_state is not None:
        net.load_state_dict({**d_state["params"], **d_state["stats"]})
    outs, conv2d = [], discriminators.conv2d

    def recorded(conv, t, h=None):
        outs.append(conv2d(conv, t, h))
        return outs[-1]

    discriminators.conv2d = recorded
    try:
        with torch.no_grad(), frozen_stats(net):
            net(x.to(dev), train=True)
    finally:
        discriminators.conv2d = conv2d
    return [collectives.gather_height(y, spatial.full_height(y)).cpu() for y in outs]


def sp_diagnose(dev, root, card):
    """The 1 x 2 plain distiller's step-1 G-loss gap, taken apart on the
    card: D's per-layer outputs over the split height against one
    process's (the seeded D, the same input: the forward path alone); D's
    parameters after step 1, split against one process (elements past
    0.5·lr apart: Adam's first step is lr·sign(g), so those are gradients
    whose sign the two runs' float sums disagree on); and the per-layer
    outputs of the two updated Ds in one process on the same input (what
    the G loss reads after D's step)."""
    import torch

    x = sp_batches()[0]["B"]
    split = torch.load(os.path.join(root, "13a_d_layers_split.pt"))
    whole = sp_d_layers(dev, x)
    fwd = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(split, whole)]
    one = torch.load(os.path.join(root, "13a_distill.pt"), map_location="cpu", weights_only=False)
    two = torch.load(os.path.join(root, "13a_distill_w2.pt"), map_location="cpu",
                     weights_only=False)
    params = {}
    for k, v in one["d"]["params"].items():
        diff = (two["d"]["params"][k] - v).detach().abs()
        params[k] = {"max_abs": float(diff.max()), "past_half_lr": int((diff > 0.5 * LR).sum()),
                     "numel": v.numel()}
    outs = [float((a - b).abs().max() / b.abs().max()) for a, b in
            zip(sp_d_layers(dev, x, two["d"]), sp_d_layers(dev, x, one["d"]))]
    flips = sum(p["past_half_lr"] for p in params.values())
    by_tensor = {k: (p["past_half_lr"], round(p["max_abs"], 7)) for k, p in params.items()}
    log(f"13 (a) diagnosis of the 1 x 2 distiller's step-1 gap: D's per-layer outputs over two "
        f"spatial ranks against one process, seeded D, same input: max rel diff "
        f"{['%.3g' % v for v in fwd]}; D after step 1: {flips} of "
        f"{sum(p['numel'] for p in params.values())} parameters more than 0.5·lr apart (Adam's "
        f"first step is lr·sign(g)), by tensor (count, max |diff|) {by_tensor}; the two "
        f"updated Ds' per-layer outputs in one process: max rel diff "
        f"{['%.3g' % v for v in outs]} [{card}]")
    return {"forward_rel": fwd, "params": params, "updated_outputs_rel": outs,
            "sign_flips": flips}


class _HaloLog:
    """The halo exchanges of this process, from zero: each forward gather
    and backward scatter with its shapes, and the step boundaries."""

    def __init__(self):
        from cat_tpu_torch.parallel import spatial

        self.spatial, self.calls, self.marks = spatial, [], []
        self._gather, self._scatter = spatial._gather_window, spatial._scatter_window

        def gather(x, plan):
            self.calls.append(("gather", tuple(x.shape), x.dtype, plan, None))
            return self._gather(x, plan)

        def scatter(g, plan, n_rows):
            self.calls.append(("scatter", tuple(g.shape), g.dtype, plan, n_rows))
            return self._scatter(g, plan, n_rows)

        spatial._gather_window, spatial._scatter_window = gather, scatter

    def restore(self):
        self.spatial._gather_window, self.spatial._scatter_window = self._gather, self._scatter

    def step(self, i):
        """Step i's calls (0-based)."""
        return self.calls[self.marks[i - 1] if i else 0:self.marks[i]]

    @staticmethod
    def strip_bytes(call):
        """The bytes this rank sends in the call: its strip of L rows (a
        gather) or the others' chunks of the strips' gradient (a scatter)."""
        _, shape, dtype, plan, _ = call
        _, n, width = plan[:3]
        b, c, _, w = shape
        return b * c * width * w * dtype.itemsize * (n - 1)


def sp_replay(calls, device):
    """Host milliseconds of ``calls`` replayed alone on ones (every rank of
    the axis replays its own, in the same order), three times."""
    import torch

    from cat_tpu_torch.parallel import spatial

    tensors = [torch.ones(shape, dtype=dtype, device=device) for _, shape, dtype, _, _ in calls]
    times = []
    for _ in range(3):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for (kind, _, _, plan, n_rows), t in zip(calls, tensors):
            if kind == "gather":
                spatial._gather_window(t, plan)
            else:
                spatial._scatter_window(t, plan, n_rows)
        torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def sp_rank_b(device, root, card):
    """13 (b) on one of two ranks sharing cuda:0: phase 6's recipe with
    --n_spatial 2 through the distill verb, 4 steps; its Gram launches and
    operands, its halo exchanges (replayed alone afterwards), then the Gram
    kernel held against its plain version on the run's own half-height
    taps (rank 0 times it while rank 1 waits)."""
    import torch
    import torch.distributed as dist

    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    steps, starts, waits, operands = [], [], [], []
    halo = _HaloLog()
    setup = entry.setup_distill
    entry.setup_distill = _instrumented(setup, steps, starts, waits,
                                        after_step=lambda _: halo.marks.append(len(halo.calls)))
    gram = ka.gram

    def counted_gram(x):
        operands.append(tuple(x.shape))
        return gram(x)

    ka.gram = counted_gram
    _sp_counts_reset()
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        run = entry.distill_main([*dp_verb_argv(root, os.path.join(root, "log_13b")),
                                  "--n_spatial", "2"], device=device)
        wall = time.perf_counter() - t0
        counts = _sp_counts()
    finally:
        entry.setup_distill = setup
        ka.gram = gram
        halo.restore()
    mem = torch.cuda.max_memory_allocated(device)
    n_steps = len(steps)
    step2 = halo.step(1)
    replay_ms = sp_replay(step2, device)
    # the run's own taps: this rank's half-height rows of its batch
    x = next(iter(run.loader))["A"].to(device)
    with torch.no_grad():
        taps = [net(x, taps=("encode",))[1]["encode"] for net in
                (run.distiller.netG_teacher, run.distiller.netG_student)]
    tap_shapes = [list(t.shape) for t in taps]
    taps = [t.reshape(t.shape[0], -1).contiguous() for t in taps]
    del run
    torch.cuda.empty_cache()
    kern = None
    dist.barrier()
    if rank == 0:
        l2 = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        kern = gram_numbers(taps, l2.zero_, card, "f32tma")
        del l2
    dist.barrier()
    out = {"rank": rank, **_loop_numbers(steps, starts, waits, VERB_BATCH, mem, wall),
           "counts": counts, "operands": sorted(set(operands)), "tap_shapes": tap_shapes,
           "exchanges_per_step": len(step2),
           "halo_bytes_per_step": sum(map(_HaloLog.strip_bytes, step2)),
           "halo_ms_alone": replay_ms, "steps_logged": n_steps, "kern": kern}
    with open(os.path.join(root, f"sp_b_{rank}.json"), "w") as f:
        json.dump(out, f)


def sp_norm_kernels(dev, t_channels, s_channels, card):
    """13 (c): the norm kernel's split entry points against their plain
    versions at the flagship's ConvNormAct shapes cut in two heights (batch
    BATCH, the stem and both downsamplings of teacher and student), in bf16
    and f32, timed beside their bounds (bytes); returns the bf16 totals of
    one step (each site once)."""
    import torch

    from cat_tpu_torch.ops import instance_norm as inorm

    gen = torch.Generator(device=dev).manual_seed(13)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    planes = [(c, SIZE >> j) for channels in (t_channels, s_channels)
              for j, c in enumerate(channels)]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                   "err": 0.0} for k in ("stats", "apply")}
        for c, hw in planes:
            x = (torch.randn(BATCH, c, hw // 2, hw, generator=gen, device=dev) * 3 + 1).to(dtype)
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev)
            got, ref = inorm.plane_sums_cuda(x), inorm.plane_sums_plain(x)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not err <= 1e-5 * float(ref.abs().max()) or not torch.isfinite(got).all():
                fail(f"13 (c) plane sums {dname} {tuple(x.shape)}: max |err| {err:g}")
            tot["stats"]["err"] = max(tot["stats"]["err"], err)
            n = x.shape[2] * x.shape[3]
            mean = ref[:, 0] / n
            rstd = torch.rsqrt(ref[:, 1] / n - mean.square() + 1e-5)
            y = inorm.norm_apply_cuda(x, mean, rstd, scale, bias, "relu")
            y_ref = inorm.norm_apply_plain(x, mean, rstd, scale, bias, "relu")
            torch.cuda.synchronize()
            rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
            diff = (y.float() - y_ref.float()).abs()
            excess = float((diff - rtol * y_ref.float().abs()).max())
            if not excess <= atol or not torch.isfinite(y).all():
                fail(f"13 (c) norm apply {dname} {tuple(x.shape)}: error beyond rtol {rtol:g} "
                     f"by {excess:g} > {atol:g}")
            tot["apply"]["err"] = max(tot["apply"]["err"], float(diff.max()))
            xb = x.numel() * x.element_size()
            nc8 = x.shape[0] * c * 8  # (Σx, Σx²) or (mean, rstd) a plane, float32
            for k, fn, plain, nbytes, flops in (
                    ("stats", lambda: inorm.plane_sums_cuda(x),
                     lambda: inorm.plane_sums_plain(x), xb + nc8, 3),
                    ("apply", lambda: inorm.norm_apply_cuda(x, mean, rstd, scale, bias),
                     lambda: inorm.norm_apply_plain(x, mean, rstd, scale, bias),
                     2 * xb + nc8, 5)):
                ms = timed(fn, flush=l2.zero_)
                plain_ms = timed(plain, flush=l2.zero_)
                bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
                ops_ms = 1e3 * flops * x.numel() / PEAK_FLOPS["float32"]
                bound = max(bytes_ms, ops_ms)
                log(f"13 (c) norm {k:5s} {dname:8s} {tuple(x.shape)}: kernel {ms:.4f} ms "
                    f"({100 * bound / ms:.1f}% of bound), plain {plain_ms:.4f} ms, bound "
                    f"{bound:.4f} ms (bytes) [{card}]")
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                               ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    tot[k][key] += v
        out[dname] = tot
    del l2
    return out["bfloat16"]


SP_SPADE_TASKS = ("teacher", "ka", "mse", "wgangp", "remat")  # 13 (e)
SP_SPADE_BATCH = 4


def sp_spade_tiny(name, dev, fused=False):
    """13 (e)'s tiny float32 GauGAN task ``name`` on ``dev`` from seeds, at
    10a's sizes (teacher ngf 16, student ngf 8, 35 labels + dontcare +
    edges, kernels 1, 3, 5, 64 x 32: a 1-row latent, which the second of two
    spatial ranks does not own; VGG, the spectral multiscale D): (step
    function of a raw batch -> metrics, train state).  "teacher": the SPADE
    teacher task (hinge); "ka", "wgangp" (its penalty's weights fixed by
    the caller), "remat": the distiller with KA on head_0, G_middle_1 and
    up_1; "mse": with the adaptors."""
    import torch

    from cat_tpu_torch.core.spade_config import (MultiscaleDiscriminatorConfig,
                                                 SPADEGeneratorConfig)
    from cat_tpu_torch.distill.spade_distiller import SPADEDistiller, SPADEDistillHParams
    from cat_tpu_torch.models.spade import SPADEGenerator
    from cat_tpu_torch.models.vgg import VGG19Features
    from cat_tpu_torch.train.spade_model import SPADEHParams, SPADETask

    kw = dict(semantic_nc=37, channels_reduction_factor=6, kernel_sizes=(1, 3, 5),
              num_upsampling_layers="normal", crop_size=64, aspect_ratio=2.0)
    tcfg = SPADEGeneratorConfig.make(ngf=16, **kw)
    dcfg = MultiscaleDiscriminatorConfig(input_nc=40, ndf=16, n_layers=4, num_D=2)
    vgg = VGG19Features()
    vgg.load_state_dict(_sp_vgg_weights())
    if name == "teacher":
        task = SPADETask(tcfg, dcfg, SPADEHParams(), vgg=vgg, input_nc=35,
                         contain_dontcare=True, device=dev)
        state = task.init_state(10)
        return (lambda b: task.train_step(state, b, LR)[1]), state
    teacher = SPADEGenerator(tcfg, "xavier", generator=torch.Generator().manual_seed(10))
    hp = SPADEDistillHParams(distill_loss_type="mse" if name == "mse" else "ka",
                             gan_mode="wgangp" if name == "wgangp" else "hinge",
                             remat=name == "remat")
    dist = SPADEDistiller(tcfg, SPADEGeneratorConfig.make(ngf=8, **kw), dcfg, hp, vgg=vgg,
                          input_nc=35, contain_dontcare=True, device=dev)
    state, tparams = dist.init_state(teacher.state_dict(), seed=10)
    return (lambda b: dist.train_step(state, tparams, b, LR)[1]), state


@functools.lru_cache(maxsize=1)
def _sp_vgg_weights():
    """13 (e)'s seeded VGG19 weights (10a's seed), drawn once a process."""
    from cat_tpu_torch.models.vgg import random_vgg19_state_dict

    return random_vgg19_state_dict(seed=19)


def sp_spade_batches():
    """13 (e)'s two raw batches (global batch 4, 64 x 32, 10a's labels)."""
    import numpy as np
    import torch

    rs = np.random.RandomState(13)
    gen = torch.Generator().manual_seed(13)
    out = []
    for _ in range(2):
        label = rs.randint(0, 34, (SP_SPADE_BATCH, 32, 64)).astype(np.float32)
        label[:, :4] = 255
        inst = np.repeat(np.repeat(rs.randint(0, 9, (SP_SPADE_BATCH, 4, 8)), 8, 1), 8, 2)
        out.append({"label": torch.from_numpy(label),
                    "instance": torch.from_numpy(inst.astype(np.int32)),
                    "image": torch.rand(SP_SPADE_BATCH, 3, 32, 64, generator=gen) * 2 - 1})
    return out


def sp_spade_part(batch, rank, n_spatial, world):
    """A rank's part of a raw SPADE batch: its data index's rows of every
    field, of the photo its height rows only (the label maps stay whole,
    as the verbs' loader keeps them)."""
    b = batch["image"].shape[0] // (world // n_spatial)
    d = rank // n_spatial
    return {k: sp_shard(v, rank, n_spatial, world) if k == "image" else v[d * b:(d + 1) * b]
            for k, v in batch.items()}


def sp_spade_runs(dev, root, rank=0, n_spatial=1, world=1):
    """13 (e)'s tasks' two steps on this process's part of the batches
    (``sp_tiny_runs``), the penalty's weights fixed."""
    undo = _sp_fixed_alpha()
    try:
        return sp_tiny_runs(dev, root, SP_SPADE_TASKS, rank, n_spatial, world,
                            make=sp_spade_tiny, batches=sp_spade_batches(), part=sp_spade_part,
                            phase="13e", keep_u=True)
    finally:
        undo()


def sp_rank_d(device, root, judge, stats, card):
    """13 (d) on one of two ranks sharing cuda:0: the 5p6B GauGAN student
    recipe with --n_spatial 2 through the distill verb for its first epoch
    (3 steps at global batch 16); its Gram launches and operands, its halo
    exchanges (replayed alone afterwards); the Gram held against its plain
    version on the run's own six half-height taps (rank 0 times it while
    rank 1 waits); then one FID + mIoU evaluation of the run's final
    student over the two ranks."""
    import torch
    import torch.distributed as dist

    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.parallel import spatial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    steps, starts, waits, operands = [], [], [], []
    halo = _HaloLog()
    setup = entry.setup_distill
    entry.setup_distill = _instrumented(setup, steps, starts, waits,
                                        after_step=lambda _: halo.marks.append(len(halo.calls)))
    gram = ka.gram
    ka.gram = lambda x: operands.append(tuple(x.shape)) or gram(x)
    _sp_counts_reset()
    try:
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        run = entry.distill_main([*gaugan_student_argv(root, judge, stats,
                                                       os.path.join(root, "log_13d")),
                                  "--no_fid", "--drn_path", os.path.join(root, "absent.pth"),
                                  "--nepochs", "1", "--n_spatial", "2"], device=device)
        wall = time.perf_counter() - t0
        counts = _sp_counts()
    finally:
        entry.setup_distill = setup
        ka.gram = gram
        halo.restore()
    mem = torch.cuda.max_memory_allocated(device)
    step2 = halo.step(1)
    replay_ms = sp_replay(step2, device)
    # the run's own taps: this rank's rows of teacher and student at the three taps
    batch = {k: v.to(device) if isinstance(v, torch.Tensor) else v
             for k, v in next(iter(run.loader)).items()}
    sem = run.distiller.semantics(batch)
    with torch.no_grad():
        taps = [acts[name] for net in (run.distiller.netG_teacher, run.distiller.netG_student)
                for acts in [net(sem, taps=SPADE_TAPS)[1]] for name in SPADE_TAPS]
    tap_shapes = [list(t.shape) for t in taps]
    tap_heights = [spatial.full_height(t) for t in taps]
    taps = [t.reshape(t.shape[0], -1).contiguous() for t in taps]
    del run, sem, batch
    torch.cuda.empty_cache()
    kern = None
    dist.barrier()
    if rank == 0:
        l2 = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        kern = gram_numbers(taps, l2.zero_, card, "f32tma",
                            names=[f"{who} {name}" for who in ("teacher", "student")
                                   for name in SPADE_TAPS], per_step=1)
        kern["b"], kern["f"] = taps[0].shape[0], [x.shape[1] for x in taps]
        del l2
    dist.barrier()
    del taps
    torch.cuda.empty_cache()
    ev = _dp_spade_eval(root, judge, stats, "13d_w2", (rank, 2), log_dir="log_13d")
    out = {"rank": rank, **_loop_numbers(steps, starts, waits, GAUGAN_BATCH, mem, wall),
           "counts": counts, "operands": sorted(set(operands)), "tap_shapes": tap_shapes,
           "tap_heights": tap_heights, "exchanges_per_step": len(step2),
           "halo_bytes_per_step": sum(map(_HaloLog.strip_bytes, step2)),
           "halo_ms_alone": replay_ms, "kern": kern, "eval": ev}
    with open(os.path.join(root, f"sp_d_{rank}.json"), "w") as f:
        json.dump(out, f)


def sp_spade_check(ranks, one, world, n_spatial, card):
    """13 (e) over one world: each rank's tiny GauGAN steps (``ranks``)
    against one process's on the card (``one``): losses within
    DP_LOSS_TOL, D's ``u`` alike on every rank, 6 Gram launches a step (KA)
    on the ranks that own the 1-row latent and 4 on those that own none of
    it (its two head_0 operands have no columns: a zero Gram, no launch)."""
    grid = f"{world // n_spatial}x{n_spatial}"
    gaps = {}
    for name in SP_SPADE_TASKS:
        gaps[name] = max(_loss_gap(rk[name]["losses"], one[name]["losses"]) for rk in ranks)
        if not gaps[name] <= DP_LOSS_TOL:
            fail(f"13 (e) {name} over {grid} ranks: losses {ranks[0][name]['losses']} against "
                 f"one process's {one[name]['losses']}: worst gap {gaps[name]:.3g} of "
                 f"max(|loss|, 0.1) (bound {DP_LOSS_TOL})")
        if any(rk[name]["d_u"] != ranks[0][name]["d_u"] for rk in ranks):
            fail(f"13 (e) {name} over {grid} ranks: D's spectral u differs between ranks")
        for r, rk in enumerate(ranks):
            c, shapes = rk[name]["counts"], rk[name]["gram_shapes"]
            owns_latent = r % n_spatial == 0
            want = 0 if name in ("teacher", "mse") else (12 if owns_latent else 8)
            empty = 0 if owns_latent or not want else 4
            if (c["gram"] != want or c.get("gram_f32tma", 0) + c.get("gram_f32", 0) != want
                    or sum(f == 0 for _, f in shapes) != empty):
                fail(f"13 (e) {name} over {grid} ranks, rank {r}: {c}, operands {shapes}; "
                     f"expected {want} launches in 2 steps, {empty} operands of no columns")
    counts = {k: v["counts"] for k, v in ranks[-1].items()}
    log(f"13 (e): tiny f32 GauGAN steps (teacher task, KA, mse, wgangp, remat; a 1-row latent) "
        f"over {world} gloo ranks on cuda:0 ({grid}) against one process on the card: worst "
        f"loss gaps {gaps} of max(|loss|, 0.1) (bound {DP_LOSS_TOL}); D's u alike on every "
        f"rank; the last rank's launches {counts} [{card}]")
    return {"loss_gaps": gaps, "counts": counts}


def sp_gaugan(card, root, judge, stats):
    """13 (d): the 5p6B GauGAN student recipe's first epoch with --n_spatial
    2 over two gloo ranks on cuda:0 (``sp_rank_d``) against phase 12 (c)'s
    one process: step 1's losses within DP_LOSS_TOL, 6 f32tma Gram launches
    a step on each rank on (16, F/2) operands; one FID + mIoU evaluation of
    its student over the two ranks against one process's (FID within 1e-3
    relative, the confusion matrix exactly)."""
    import numpy as np
    import torch

    from cat_tpu_torch.parallel import mesh

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh.spawn(sp_rank_d, 2, args=(root, judge, stats, card), device="cuda:0", backend="gloo",
               timeout=SP_TIMEOUT)
    spawn_d = time.perf_counter() - t0
    ranks_d = []
    for r in (0, 1):
        with open(os.path.join(root, f"sp_d_{r}.json")) as f:
            ranks_d.append(json.load(f))
    d_losses = _scalars(os.path.join(root, "log_13d"))
    d_want = _scalars(os.path.join(root, "log_12c_w1"))  # 12 (c)'s one-process first epoch
    d_gaps = [_loss_gap(d_losses[:i + 1], d_want[:i + 1]) for i in range(len(d_want))]
    for rk in ranks_d:
        c = rk["counts"]
        if (rk["steps"] != DP_SPADE_STEPS or c["gram"] != 6 * DP_SPADE_STEPS
                or c.get("gram_f32tma") != c["gram"]
                or [2 * s[2] for s in rk["tap_shapes"]] != rk["tap_heights"]
                or sorted({f for _, f in rk["operands"]})
                != sorted({s[1] * s[2] * s[3] for s in rk["tap_shapes"]})
                or any(b != GAUGAN_BATCH for b, _ in rk["operands"])):
            fail(f"13 (d) rank {rk['rank']}: {rk['steps']} steps, {c}, Gram operands "
                 f"{rk['operands']}, taps {rk['tap_shapes']}; expected {DP_SPADE_STEPS} steps, "
                 f"6 f32tma Gram launches a step on ({GAUGAN_BATCH}, F/2) operands (taps of "
                 f"half of {rk['tap_heights']} rows)")
    if (not d_gaps or not d_gaps[0] <= DP_LOSS_TOL or len(d_losses) != DP_SPADE_STEPS
            or not all(math.isfinite(v) for r in d_losses for v in r.values())):
        fail(f"13 (d): losses over two spatial ranks {d_losses} against one process's {d_want}: "
             f"step 1's gap {d_gaps[:1]} of max(|loss|, 0.1) (bound {DP_LOSS_TOL}), all finite")
    ev1 = _dp_spade_eval(root, judge, stats, "13d_w1", log_dir="log_13d")
    for rk in ranks_d:
        ev = rk["eval"]
        if not (abs(ev["fid"] - ev1["fid"]) <= 1e-3 * abs(ev1["fid"]) and ev["hist"] == ev1["hist"]
                and ev["miou"] == ev1["miou"]):
            fail(f"13 (d) rank {rk['rank']}: the evaluation over two spatial ranks (FID "
                 f"{ev['fid']}, mIoU {ev['miou']}) differs from one process's (FID "
                 f"{ev1['fid']}, mIoU {ev1['miou']}) or its confusion matrix does")
    log(f"13 (d): the GauGAN 5p6B student recipe at global batch {GAUGAN_BATCH}, 512x256, "
        f"--n_spatial 2 over two gloo ranks on cuda:0 (not a scaling measurement): step 1's "
        f"losses within {d_gaps[0]:.3g} of max(|loss|, 0.1) of one process's (phase 12 (c); "
        f"bound {DP_LOSS_TOL}), through steps 1-{len(d_gaps)} "
        f"{[float(f'{g:.3g}') for g in d_gaps]}; "
        + "; ".join(f"rank {rk['rank']}: median step {rk['step_ms_median']:.1f} ms (steps "
                    f"{rk['step_ms']}), {rk['exchanges_per_step']} halo exchanges a step, "
                    f"{rk['halo_bytes_per_step'] / 2 ** 20:.0f} MiB sent, "
                    f"{np.median(rk['halo_ms_alone']):.1f} ms alone, peak memory "
                    f"{rk['peak_memory_gib']:.2f} GiB, loader wait "
                    f"{rk['loader_wait_ms_per_step']:.1f} ms a step, {rk['counts']}"
                    for rk in ranks_d)
        + f"; one evaluation of its student over the two ranks: FID "
          f"{ranks_d[0]['eval']['fid']:.6f} against {ev1['fid']:.6f} in one process, mIoU "
          f"{ranks_d[0]['eval']['miou']} against {ev1['miou']}, confusion matrices equal; "
          f"{ranks_d[0]['eval']['seconds']:.1f} s and {ev1['seconds']:.1f} s [{card}]")
    return {"loss_gap": d_gaps[0], "loss_gaps_by_step": d_gaps, "losses": d_losses,
            "ranks": ranks_d, "eval_one_process": ev1, "spawn_s": spawn_d}


def spatial_parallel(card, root, dp, teacher_cfg, student_cfg, judge, stats):
    """Phase 13: (a) the tiny tasks in one process on the card, then over
    two gloo ranks sharing cuda:0 as 1 x 2 and over four as 2 x 2 (and the
    fused-norm distiller at 1 x 2: the split entry points), and the
    diagnosis of the 1 x 2 distiller's step-1 gap; (e) the tiny GauGAN
    tasks the same way, on the same ranks; (b) phase 6's recipe with --n_spatial 2 over two
    ranks against phase 12 (a)'s one process; (d) the 5p6B GauGAN student
    recipe with --n_spatial 2 against phase 12 (c)'s one process, and one
    evaluation of its student over the two ranks against one process's;
    (c) the split entry points against their plain versions.  Two or four
    ranks on one card measure the path, not scaling."""
    import numpy as np
    import torch

    from cat_tpu_torch.models.generator import fused_norm_sites
    from cat_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    # (a) one process: every task's two steps (it writes the state after step 1)
    undo = _sp_fixed_alpha()
    try:
        one = sp_tiny_runs(dev, root, SP_TASKS + ("distill_fused",))
    finally:
        undo()
    one_e = sp_spade_runs(dev, root)  # (e) in one process
    torch.cuda.empty_cache()
    a, e = {}, {}
    # the fused tiny distiller's norm sites in 2 steps (packed blocks, both nets)
    fused_sites = 2 * sum(len(fused_norm_sites(sp_cfgs("instance", ngf, 3)[0], True, 32))
                          for ngf in (8, 4))
    for world, n_spatial in SP_WORLDS:
        t0 = time.perf_counter()
        mesh.spawn(sp_rank_a, world, args=(root, n_spatial), device="cuda:0", backend="gloo",
                   timeout=SP_TIMEOUT)
        ranks = []
        for r in range(world):
            with open(os.path.join(root, f"sp_a{world}_{r}.json")) as f:
                ranks.append(json.load(f))
        e[f"{world // n_spatial}x{n_spatial}"] = sp_spade_check(
            [rk.pop("spade") for rk in ranks], one_e, world, n_spatial, card)
        gaps, worst = {}, {}
        for name in ranks[0]:
            gaps[name] = max(_loss_gap(rk[name]["losses"], one[name]["losses"]) for rk in ranks)
            # the step and loss of the largest gap, beside the one-process value
            worst[name] = max((abs(g[k] - w[k]) / max(abs(w[k]), 0.1), i + 1, k, w[k])
                              for rk in ranks for i, (g, w) in
                              enumerate(zip(rk[name]["losses"], one[name]["losses"]))
                              for k in w)[1:]
            if not gaps[name] <= DP_LOSS_TOL:
                fail(f"13 (a) {name} over {world} ranks ({world // n_spatial} x {n_spatial}): "
                     f"losses {ranks[0][name]['losses']} against one process's "
                     f"{one[name]['losses']}: worst gap {gaps[name]:.3g} of max(|loss|, 0.1) "
                     f"(bound {DP_LOSS_TOL})")
        for rk in ranks:
            c = rk["distill"]["counts"]
            if c["gram"] != 8 or c.get("gram_f32tma", 0) + c.get("gram_f32", 0) != 8:
                fail(f"13 (a) distill over {world} ranks: Gram launches {c}, expected 8 in "
                     "2 steps (two taps, teacher and student)")
            if "distill_fused" in rk:
                cf = rk["distill_fused"]["counts"]
                if (cf["split_stats"] != fused_sites or cf["split_apply"] != fused_sites
                        or cf["instance_norm_act"]):
                    fail(f"13 (a)/(c) fused distill over {world} ranks: {cf}; expected "
                         f"{fused_sites // 2} launches a step of each split entry point and none "
                         "of the whole-plane kernel")
        if one["distill_fused"]["counts"]["instance_norm_act"] != fused_sites:
            fail(f"13 (a) fused distill in one process: {one['distill_fused']['counts']}, "
                 f"expected {fused_sites} whole-plane launches")
        a[f"{world // n_spatial}x{n_spatial}"] = {"loss_gaps": gaps, "worst": worst, "seconds":
                                                  time.perf_counter() - t0,
                                                  "counts": {k: v["counts"]
                                                             for k, v in ranks[0].items()}}
        log(f"13 (a): tiny f32 steps over {world} gloo ranks on cuda:0 "
            f"({world // n_spatial} x {n_spatial}) against one process on the card: worst loss "
            f"gaps {gaps} of max(|loss|, 0.1) (bound {DP_LOSS_TOL}), at (step, loss, "
            f"one-process value) {worst}; rank 0's launches "
            f"{a[f'{world // n_spatial}x{n_spatial}']['counts']} "
            f"[{card}]")
        if world == n_spatial:
            a["diagnosis"] = sp_diagnose(dev, root, card)

    # (b) the flagship recipe at full width over two ranks
    t0 = time.perf_counter()
    mesh.spawn(sp_rank_b, 2, args=(root, card), device="cuda:0", backend="gloo",
               timeout=SP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in (0, 1):
        with open(os.path.join(root, f"sp_b_{r}.json")) as f:
            ranks.append(json.load(f))
    n_steps = DP_EPOCHS * VERB_IMAGES // VERB_BATCH
    b_losses = _scalars(os.path.join(root, "log_13b"))
    # step 1 is held to the bound; later steps are reported: the instance
    # norms' float32 E[x²] - mean², summed over two ranks' rows instead of
    # one plane, moves some weight gradients by ~1e-4 relative (reassociating
    # the sums in one process does as much, tests/test_torch_spatial_verb.py),
    # and Adam's first steps turn the near-zero ones into ±lr
    b_gaps = [_loss_gap(b_losses[:i + 1], dp["a"]["losses"][:i + 1])
              for i in range(len(dp["a"]["losses"]))]
    b_gap = b_gaps[0]
    for rk in ranks:
        c = rk["counts"]
        shapes = rk["tap_shapes"]
        if (rk["steps"] != n_steps or c["gram"] != 8 * n_steps
                or c.get("gram_f32tma") != c["gram"]
                or any(s[0] != VERB_BATCH or s[2] != SIZE // 8 for s in shapes)
                or not {s[1] * s[2] * s[3] for s in shapes} <= {f for _, f in rk["operands"]}
                or any(b != VERB_BATCH for b, _ in rk["operands"])):
            fail(f"13 (b) rank {rk['rank']}: {rk['steps']} steps, {c}, Gram operands "
                 f"{rk['operands']}, encode taps {shapes}; expected {n_steps} steps, 8 f32tma "
                 f"Gram launches a step on ({VERB_BATCH}, F/2) operands (taps of {SIZE // 8} "
                 "rows)")
    if (not b_gap <= DP_LOSS_TOL or len(b_losses) != n_steps
            or not all(math.isfinite(v) for r in b_losses for v in r.values())):
        fail(f"13 (b): losses over two spatial ranks {b_losses} against one process's "
             f"{dp['a']['losses']}: step 1's gap {b_gap:.3g} of max(|loss|, 0.1) (bound "
             f"{DP_LOSS_TOL}), all steps finite")
    log(f"13 (b): the 2p6B recipe at global batch {VERB_BATCH}, --n_spatial 2 over two gloo "
        f"ranks on cuda:0 (not a scaling measurement): step 1's losses within {b_gap:.3g} of "
        f"max(|loss|, 0.1) of one process's (phase 12 (a); bound {DP_LOSS_TOL}), through steps "
        f"1-{len(b_gaps)} {[float(f'{g:.3g}') for g in b_gaps]} (phase 12 (b)'s data-parallel "
        f"ranks: {dp['b']['loss_gap']:.3g}); "
        + "; ".join(f"rank {rk['rank']}: median step {rk['step_ms_median']:.1f} ms, "
                    f"{rk['exchanges_per_step']} halo exchanges a step, "
                    f"{rk['halo_bytes_per_step'] / 2 ** 20:.0f} MiB sent, "
                    f"{np.median(rk['halo_ms_alone']):.1f} ms alone, peak memory "
                    f"{rk['peak_memory_gib']:.2f} GiB, {rk['counts']}" for rk in ranks)
        + f" [{card}]")

    # (d) the GauGAN student recipe at full width over two ranks
    d = sp_gaugan(card, root, judge, stats)

    # (c) the split entry points at the flagship's shapes, half height
    kern_c = sp_norm_kernels(dev, teacher_cfg.ds_channels, student_cfg.ds_channels, card)
    out = {"a": a, "b": {"loss_gap": b_gap, "loss_gaps_by_step": b_gaps, "losses": b_losses,
                         "ranks": ranks, "spawn_s": spawn_s},
           "c": kern_c, "e": e, "d": d, "seconds": time.perf_counter() - t_phase}
    return out


# ---------------------------------------------------------------------------
# Phase 14: the int8 teacher, the UNet with GenericDistiller, DeepLab v2
# ---------------------------------------------------------------------------

INT8_PEAK_OPS = 1978.9e12  # dense int8 tensor-core operations/s, H100 SXM
INT8_EPOCHS = 2  # 14 (b): 4 steps of phase 6's recipe at batch 80
UNET_BATCH, UNET_STEPS = 32, 4  # 14 (d): tools/bench_unet_distill.py's batch; 1 warm-up + 3
DEEPLAB_HW = 513  # 14 (e): the reference's evaluation crop
INT8_CPU_IMAGES = 2  # 14 (b): the card's int8 teacher against the CPU's on this many images
INT8_CPU_TOL = 5e-3  # 14 (b): the first float32 tap's relative L2 error, card against CPU


def record_convs(fn, *args):
    """The convolutions of ``fn(*args)`` (under no_grad) in call order:
    {signature: [count, weight, input shape without the batch, the conv's
    keyword arguments]} and the number of calls."""
    import torch
    from torch.overrides import TorchFunctionMode

    from cat_tpu_torch.ops import quant as tq

    seen = {}

    class Recorder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            parse = tq._CONVS.get(func)
            if parse is not None:
                x, w, _, kw = parse(*args, **(kwargs or {}))
                key = (tuple(x.shape[1:]), tuple(w.shape), json.dumps(kw, sort_keys=True))
                entry = seen.setdefault(key, [0, w.detach().clone(), tuple(x.shape[1:]), kw])
                entry[0] += 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Recorder():
        fn(*args)
    return seen, sum(v[0] for v in seen.values())


def teacher_convs(dev, teacher_cfg, teacher_sd):
    """The flagship teacher's convolutions in call order, as one bf16
    forward runs them (``record_convs``)."""
    import torch

    from cat_tpu_torch.models.generator import InceptionGenerator

    teacher = InceptionGenerator(teacher_cfg, packed_blocks=True)
    teacher.load_state_dict(teacher_sd)
    teacher = teacher.to(dev).bfloat16().eval()
    return record_convs(teacher, torch.zeros(1, 3, SIZE, SIZE, device=dev, dtype=torch.bfloat16))


def int8_conv_numbers(dev, card, convs, batch=VERB_BATCH, dtype_name="bfloat16",
                      timed_paths=("intmm", "grouped"), what="the flagship teacher"):
    """Every distinct conv of a teacher (``record_convs``) at ``batch`` in
    ``dtype_name``, on seeded inputs: the int32 accumulator of the card's
    path (im2col + torch._int_mm for groups 1, csrc/int8_conv.cu otherwise;
    a transposed conv through its stride-1 lowering) equal to the float64
    plain version bit for bit (a transposed conv's held against
    F.conv_transpose2d in float64 itself), and the dequantised output in
    that dtype (for a grouped conv the kernel's fused store) equal to the
    plain dequantisation's.  For the paths in ``timed_paths``, times of the
    quantisation (activation and weight), the accumulator, the
    dequantisation (for a grouped conv, the kernel with it fused), the
    whole ``int8_conv``, the plain version (float64 accumulator between the
    same quantisation and dequantisation) and cuDNN's conv in that dtype;
    the bound is the larger of the input's, output's and weight's bytes
    over 3.35 TB/s and 2·MACs over the dense int8 peak.  Returns each
    path's totals over one teacher forward (each shape times its count)."""
    import torch
    import torch.nn.functional as F

    from cat_tpu_torch.ops import quant as tq

    dtype = getattr(torch, dtype_name)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def flush():
        l2.zero_()

    gen = torch.Generator(device=dev).manual_seed(14)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms", "quant_ms",
            "conv_ms", "dequant_ms")
    tot = {path: {**dict.fromkeys(keys, 0.0), "err": 0.0, "convs": 0, "shapes": 0,
                  "timed": path in timed_paths}
           for path in ("intmm", "grouped")}
    for count, w, xshape, kw in convs.values():
        kw = dict(kw)
        transposed, g = kw.get("transposed", False), kw["groups"]
        x = torch.randn(batch, *xshape, generator=gen, device=dev).to(dtype)
        w = w.to(dtype)
        wr = tq.transposed_weight(w, g) if transposed else w

        def quantised():
            qx = tq.act_scale(x)
            qw = tq.weight_scale(wr)
            return qx, qw, tq.quantize(x, qx), tq.quantize(wr, qw.view(-1, 1, 1, 1))

        qx, qw, xq, wq = quantised()
        scale = qx * qw
        if transposed:
            def lowered():
                return tq.lower_transposed(xq, wr.shape[2:], kw["stride"], kw["padding"],
                                           kw["output_padding"], kw["dilation"])
            conv_args = (1, 0, kw["dilation"], g)
        else:
            def lowered():
                return xq
            conv_args = (kw["stride"], kw["padding"], kw["dilation"], g)
        xl = lowered()
        acc = tq.int8_conv_acc(xl, wq, *conv_args)
        if transposed:
            wq_t = tq.quantize(w, qw.view(1, -1, 1, 1))  # groups 1: output channels on dim 1
            want = F.conv_transpose2d(xq.double(), wq_t.double(), None, kw["stride"],
                                      kw["padding"], kw["output_padding"], g,
                                      kw["dilation"]).to(torch.int32)
            del wq_t
        else:
            want = tq.int8_conv_acc_plain(xl, wq, *conv_args)
        y = tq.conv_dequant(xl, wq, scale, dtype, *conv_args)
        y_plain = (want.float() * scale.view(1, -1, 1, 1)).to(dtype)
        torch.cuda.synchronize()
        shape = f"int8 conv x {tuple(x.shape)} w {tuple(w.shape)} {kw} ({dtype_name})"
        if not torch.equal(acc, want):
            fail(f"{shape}: the card's int32 accumulator differs from the float64 plain version "
                 f"at {int((acc != want).sum())} of {acc.numel()} values")
        if not torch.equal(y, y_plain):
            fail(f"{shape}: the dequantised output differs from the plain dequantisation")
        path = "intmm" if g == 1 else "grouped"
        tot[path]["convs"] += count
        tot[path]["shapes"] += 1
        desc = (f"int8 conv {path:7s} x {tuple(x.shape)} w {tuple(w.shape)} stride "
                f"{kw['stride']} pad {kw['padding']} groups {g}"
                f"{' transposed' if transposed else ''} (x{count} a forward)")
        if path not in timed_paths:
            log(f"{desc}: accumulator exact, {dtype_name} output bit-equal [{card}]")
            del x, xq, xl, acc, y, want, y_plain
            continue
        macs = (x.shape[0] * xshape[0] * xshape[1] * xshape[2] * w.shape[1] * w.shape[2]
                * w.shape[3] if transposed else acc.numel() * wr.shape[1] * wr.shape[2]
                * wr.shape[3])
        del want, y_plain

        def library():
            if transposed:
                return F.conv_transpose2d(x, w, None, kw["stride"], kw["padding"],
                                          kw["output_padding"], g, kw["dilation"])
            return F.conv2d(x, w, None, kw["stride"], kw["padding"], kw["dilation"], g)

        t = {"quant_ms": timed(quantised, flush, iters=5),
             "conv_ms": timed(lambda: tq.int8_conv_acc(lowered(), wq, *conv_args), flush,
                              iters=5),
             "ms": timed(lambda: tq.int8_conv(x, w, None, **kw), flush, iters=5),
             "library_ms": timed(library, flush, iters=5)}
        if g == 1:
            t["dequant_ms"] = timed(
                lambda: (acc.float() * scale.view(1, -1, 1, 1)).to(dtype), flush, iters=5)
        else:  # the kernel with the dequantisation fused, less the accumulator alone
            fused = timed(lambda: tq.conv_dequant(xl, wq, scale, dtype, *conv_args),
                          flush, iters=5)
            t["dequant_ms"] = fused - t["conv_ms"]
        plain_acc = timed(lambda: tq.int8_conv_acc_plain(lowered(), wq, *conv_args), flush,
                          iters=3)
        t["plain_ms"] = t["quant_ms"] + plain_acc + max(t["dequant_ms"], 0.0)
        t["bytes_ms"] = (1e3 * x.element_size() * (x.numel() + w.numel() + y.numel())
                         / HBM_BYTES_PER_S)
        t["ops_ms"] = 1e3 * 2 * macs / INT8_PEAK_OPS
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        log(f"{desc}: quantise {t['quant_ms']:.4f} ms, accumulator {t['conv_ms']:.4f} ms, "
            f"dequantise {t['dequant_ms']:.4f} ms, int8_conv {t['ms']:.4f} ms, plain (float64 "
            f"accumulator) {t['plain_ms']:.4f} ms, cuDNN {dtype_name} conv "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes {t['bytes_ms']:.4f}, "
            f"2·MACs = {2 * macs / 1e9:.2f} GOP at 1978.9 TOP/s {t['ops_ms']:.4f}); accumulator "
            f"exact, {dtype_name} output bit-equal [{card}]")
        for k in keys:
            tot[path][k] += count * t[k]
        del x, xq, xl, acc, y
        torch.cuda.empty_cache()
    del l2
    torch.cuda.empty_cache()
    for path, t in tot.items():
        if not t["timed"]:
            log(f"int8 conv {path}: {what} at batch {batch}, {dtype_name}: {t['convs']} convs, "
                f"{t['shapes']} shapes, every accumulator exact and every output bit-equal "
                f"[{card}]")
            continue
        log(f"int8 conv {path}: one forward of {what} at batch {batch}, {dtype_name} "
            f"({t['convs']} convs, {t['shapes']} shapes): int8_conv {t['ms']:.3f} ms (quantise "
            f"{t['quant_ms']:.3f}, accumulator {t['conv_ms']:.3f}, dequantise "
            f"{t['dequant_ms']:.3f}), cuDNN {dtype_name} {t['library_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms; every accumulator exact "
            f"[{card}]")
    return tot


@contextlib.contextmanager
def plain_accumulator():
    """Within the block ``int8_conv`` takes every accumulator from the
    float64 plain version (on the card too) and dequantises it plainly:
    the yardstick of a whole int8 forward."""
    from cat_tpu_torch.ops import quant as tq

    def dequant(xq, wq, scale, dtype, stride=1, padding=0, dilation=1, groups=1):
        acc = tq.int8_conv_acc_plain(xq, wq, stride, padding, dilation, groups)
        return (acc.float() * scale.view(1, -1, 1, 1)).to(dtype)

    card = tq.conv_dequant
    tq.conv_dequant = dequant
    try:
        yield
    finally:
        tq.conv_dequant = card


def _rel_errs(got, ref):
    """Each tap's relative L2 error against ``ref`` (both on one device)."""
    return {k: float((got[k].float() - ref[k].float()).norm() / ref[k].float().norm())
            for k in ref}


def int8_verbs(dev, card, root, verb_b, n_convs):
    """14 (b): phase 6 (b)'s run (bf16, the bank) with --teacher_compute_dtype
    int8 and int8_static, 4 steps each: 8 bf16 TMA Gram launches a step and
    the int8 paths launched; the step beside 6 (b)'s; the teacher's taps
    against the bf16 teacher's on the run's batch, and bit-equal to the same
    forward over the float64 plain accumulator (``plain_accumulator``); the
    forward in float32 on the card held against the CPU's (the plain
    accumulator) on the run's first INT8_CPU_IMAGES images, with the run's
    weights and scales: the first tap within INT8_CPU_TOL, the later ones
    within 0.25; int8_static's scales one per teacher conv; the Gram held
    against its plain version on the int8 run's own taps."""
    import copy

    import torch
    from torch.func import functional_call

    from cat_tpu_torch.ops import quant as tq
    from cat_tpu_torch.train.common import cast_floats

    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out, kern = {}, None
    for mode in ("int8", "int8_static"):
        tq.launches.update(dict.fromkeys(tq.launches, 0))
        res, run, x = run_verb(root, f"14b_{mode}", ["--compute_dtype", "bfloat16",
                                                    "--on_device_data", "1",
                                                    "--teacher_compute_dtype", mode],
                               "tma", dev, card, epochs=INT8_EPOCHS)
        launches = dict(tq.launches)
        if not (launches["intmm"] and launches["grouped"]):
            fail(f"14 (b) {mode}: the int8 paths were not both launched: {launches}")
        dist = run.distiller
        scales = dist._act_scales
        params = cast_floats(dict(dist.netG_teacher.named_parameters()), torch.bfloat16)
        xb = x.to(torch.bfloat16)
        (_, ref), _ = tq.teacher_forward(dist._teacher_fn, params, xb, "", None)
        (_, got), _ = tq.teacher_forward(dist._teacher_fn, params, xb, mode, scales)
        rel = _rel_errs(got, ref)
        if not all(r < 0.25 for r in rel.values()):
            fail(f"14 (b) {mode}: the int8 teacher's taps are far from the bf16 teacher's: {rel}")
        # the same forward with every accumulator taken from the float64
        # plain version on the card: the rest of the forward is the same
        # code on the same device, so an exact accumulator gives equal bits
        with plain_accumulator():
            (_, plain), _ = tq.teacher_forward(dist._teacher_fn, params, xb, mode, scales)
        unequal = [k for k in plain if not torch.equal(got[k], plain[k])]
        if unequal:
            fail(f"14 (b) {mode}: the int8 teacher's taps {unequal} differ from those of the "
                 f"same forward over the float64 plain accumulator: {_rel_errs(got, plain)}")
        # the card's forward against the CPU's, in float32: the norms sum in
        # another order, an int8 value that this moves across a rounding
        # boundary changes its conv's outputs by a level's share, and those
        # move later boundaries in turn, so only the first tap is held tight
        cpu_net = copy.deepcopy(dist.netG_teacher).cpu().float()
        tap_names = dist.hp.mapping_layers

        def cpu_fn(p, xc):
            return functional_call(cpu_net, p, (xc,), {"train": False, "taps": tap_names})

        xs = x[:INT8_CPU_IMAGES].float()
        t0 = time.perf_counter()
        (_, cpu_taps), _ = tq.teacher_forward(cpu_fn, dict(cpu_net.named_parameters()),
                                              xs.cpu(), mode, scales)
        cpu_s = time.perf_counter() - t0
        (_, card_taps), _ = tq.teacher_forward(
            dist._teacher_fn, cast_floats(dict(dist.netG_teacher.named_parameters()),
                                          torch.float32), xs, mode, scales)
        cpu_rel = _rel_errs({k: v.cpu() for k, v in card_taps.items()}, cpu_taps)
        bounds = {k: INT8_CPU_TOL if k == tap_names[0] else 0.25 for k in cpu_rel}
        if not all(cpu_rel[k] <= bounds[k] for k in cpu_rel):
            fail(f"14 (b) {mode}: the card's float32 int8 teacher against the CPU's on "
                 f"{INT8_CPU_IMAGES} images: relative L2 errors {cpu_rel}, bounds {bounds}")
        n_scales = None
        if mode == "int8_static":
            n_scales = len(scales)
            if n_scales != n_convs:
                fail(f"14 (b): {n_scales} calibrated scales, the teacher runs {n_convs} convs")
        res.update(mode=mode, int8_launches=launches, taps_rel_err=rel, scales=n_scales,
                   cpu_rel_err=cpu_rel, step_ms_6b=verb_b["step_ms_median"])
        log(f"14 (b) {mode}: median step {res['step_ms_median']:.1f} ms against 6 (b)'s bf16 "
            f"teacher {verb_b['step_ms_median']:.1f} ms; int8 launches {launches} in "
            f"{res['steps']} steps; the teacher's taps against the bf16 teacher's on the same "
            f"batch, relative L2 error {rel}; bit-equal to the same forward over the float64 "
            f"plain accumulator; in float32 on {INT8_CPU_IMAGES} of its images, the card's "
            f"taps against the CPU's, relative L2 error {cpu_rel} (bounds {bounds}; CPU "
            f"forward {cpu_s:.1f} s); scales {n_scales} (teacher convs {n_convs}) [{card}]")
        if mode == "int8":
            with torch.no_grad():
                taps = [got["encode"].reshape(xb.shape[0], -1).contiguous(),
                        dist.netG_student(x, taps=("encode",))[1]["encode"]
                        .reshape(x.shape[0], -1).to(torch.bfloat16).contiguous()]
            kern = gram_numbers(taps, l2.zero_, card, "tma")
            del taps
        out[mode] = res
        del run, dist, params, ref, got, plain, cpu_net, cpu_taps, card_taps
        torch.cuda.empty_cache()
    del l2
    return out, kern


def gaugan_teacher_convs(dev, card, dist):
    """14 (c): every distinct conv of the distiller's GauGAN teacher
    (packed branches, depthwise convs at SPADE widths, groups-1 convs at
    512x256) held on the card at the recipe's batch in its float32
    (``int8_conv_numbers``: accumulators exact, the fused float32 store and
    the plain dequantisation bit-equal), its grouped convs timed; their
    count equal to the calibrated scales'."""
    import torch

    from cat_tpu_torch.train.common import cast_floats

    cfg = dist.netG_teacher.cfg
    sh, sw = cfg.latent_size()
    up = 2 ** {"normal": 5, "more": 6, "most": 7}[cfg.num_upsampling_layers]
    params = cast_floats(dict(dist.netG_teacher.named_parameters()), dist.prec.dtype)
    sem = torch.zeros(1, cfg.semantic_nc, sh * up, sw * up, device=dev, dtype=dist.prec.dtype)
    convs, n_convs = record_convs(dist._teacher_fn, params, sem)
    if dist._act_scales is not None and n_convs != len(dist._act_scales):
        fail(f"14 (c): the GauGAN teacher runs {n_convs} convs, {len(dist._act_scales)} "
             "calibrated scales")
    log(f"14 (c): the GauGAN teacher runs {n_convs} convs, {len(convs)} distinct, over "
        f"{sh * up}x{sw * up} semantics")
    tot = int8_conv_numbers(dev, card, convs, GAUGAN_BATCH, str(dist.prec.dtype).split(".")[1],
                            ("grouped",), "the GauGAN teacher")
    return tot, n_convs


def int8_gaugan(dev, card, root, judge, stats, spade_b):
    """14 (c): the 5p6B GauGAN student recipe (10b's flags, 9c's teacher)
    with --teacher_compute_dtype int8_static for its first epoch (3 steps,
    no evaluations): median step beside 10b's, peak memory, 6 f32tma Gram
    launches a step, the int8 paths launched, the calibrated scales; then
    the teacher's convs on the card (``gaugan_teacher_convs``)."""
    from cat_tpu_torch import entry
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.ops import quant as tq

    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    tq.launches.update(dict.fromkeys(tq.launches, 0))
    log_dir = os.path.join(root, "log_14c")
    out, run = _instrumented_run(
        "setup_distill", entry.distill_main,
        [*gaugan_student_argv(root, judge, stats, log_dir), "--no_fid", "--drn_path",
         os.path.join(root, "absent.pth"), "--nepochs", "1", "--teacher_compute_dtype",
         "int8_static", *(["--remat", "1"] if spade_b["remat"] else [])],
        REMAT_STEPS, GAUGAN_BATCH, "14c GauGAN student, int8_static teacher", card)
    launches = dict(tq.launches)
    if ka.path_launches["f32tma"] != 6 * REMAT_STEPS or ka.launches != 6 * REMAT_STEPS:
        fail(f"14 (c): {ka.path_launches['f32tma']} f32tma Gram launches in {REMAT_STEPS} "
             "steps; expected 6 a step")
    if not (launches["intmm"] and launches["grouped"]) or not run.distiller._act_scales:
        fail(f"14 (c): int8 launches {launches}, scales {run.distiller._act_scales}")
    out.update(gram_launches=ka.launches, int8_launches=launches,
               scales=len(run.distiller._act_scales), step_ms_10b=spade_b["step_ms_median"])
    log(f"14 (c): median step {out['step_ms_median']:.1f} ms against 10b's float32 teacher "
        f"{spade_b['step_ms_median']:.1f} ms, peak memory {out['peak_memory_gib']:.2f} GiB "
        f"(10b {spade_b['peak_memory_gib']:.2f}); {ka.launches} f32tma Gram launches; int8 "
        f"launches {launches}; {out['scales']} calibrated scales [{card}]")
    out["convs"], _ = gaugan_teacher_convs(dev, card, run.distiller)
    return out


def unet_distill(dev, card):
    """14 (d): GenericDistiller at tools/bench_unet_distill.py's
    configuration (teacher base 64 -> student base 32, mults 1, 2, 4, two res
    blocks, 256 px, batch 32, bf16, KA on down1, mid and up1, l2
    reconstruction, λ 1 and 1; seeded random weights and inputs): 1 warm-up
    and 3 timed steps, peak memory, 6 bf16 TMA Gram launches a step, and the
    Gram held against its plain version on the run's own six taps."""
    import numpy as np
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.generic import GenericDistillHParams, GenericDistiller
    from cat_tpu_torch.models.unet import UNet, UNetConfig
    from cat_tpu_torch.train.common import cast_floats

    torch.manual_seed(0)
    t_cfg = UNetConfig(base=64, mults=(1, 2, 4), res_blocks=2)
    s_cfg = UNetConfig(base=32, mults=(1, 2, 4), res_blocks=2)
    taps = ("down1", "mid", "up1")
    hp = GenericDistillHParams(distill_loss_type="ka", recon_loss_type="l2", lambda_recon=1.0,
                               lambda_distill=1.0, mapping_layers=taps,
                               compute_dtype="bfloat16")
    dist = GenericDistiller(UNet(t_cfg), UNet(s_cfg), t_cfg.tap_widths, s_cfg.tap_widths, hp,
                            device=dev)
    state, tparams = dist.init_state(seed=0)
    x = torch.randn(UNET_BATCH, 3, SIZE, SIZE, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ka.launches = 0
    ka.path_launches.update(dict.fromkeys(ka.path_launches, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(UNET_STEPS):
        t0 = time.perf_counter()
        state, m = dist.train_step(state, tparams, (x,), 1e-4)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    mem = torch.cuda.max_memory_allocated()
    if (ka.launches != 6 * UNET_STEPS or ka.path_launches["tma"] != ka.launches
            or not all(math.isfinite(v) for r in losses for v in r.values())):
        fail(f"14 (d) UNet: Gram launches {ka.launches} ({ka.path_launches['tma']} tma) in "
             f"{UNET_STEPS} steps, expected 6 a step; losses {losses}")
    step_ms = 1e3 * float(np.median(times[1:]))
    out = {"steps": UNET_STEPS, "step_ms": [round(1e3 * t, 1) for t in times],
           "step_ms_median": step_ms, "images_per_s": UNET_BATCH / (step_ms / 1e3),
           "peak_memory_gib": mem / 2 ** 30, "gram_launches": ka.launches,
           "last_losses": losses[-1]}
    log(f"14 (d) UNet GenericDistiller: median step {step_ms:.1f} ms over steps 2-{UNET_STEPS} "
        f"({out['images_per_s']:.1f} images/s; warm-up {1e3 * times[0]:.0f} ms), peak memory "
        f"{mem / 2**30:.2f} GiB, {ka.launches} Gram launches (tma), losses {losses[-1]} [{card}]")
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        xb = x.to(torch.bfloat16)
        ops = [acts[name].reshape(UNET_BATCH, -1).contiguous()
               for net, p in ((dist.teacher, tparams), (dist.student, state.params))
               for acts in [torch.func.functional_call(
                   net, cast_floats(p, torch.bfloat16), (xb,), {"taps": taps})[1]]
               for name in taps]
    names = [f"{who} {name}" for who in ("teacher", "student") for name in taps]
    kern = gram_numbers(ops, l2.zero_, card, "tma", names=names, per_step=1)
    kern["b"], kern["f"] = UNET_BATCH, [o.shape[1] for o in ops]
    del ops, l2, dist, state, tparams, x
    torch.cuda.empty_cache()
    return out, kern


def deeplab(dev, card):
    """14 (e): DeepLabV2 in ResNet-101 DeepLab v2's published layout
    (n_blocks 3, 4, 23, 3; atrous rates 6, 12, 18, 24; 182 classes) under
    MSC, seeded random weights and batch-norm statistics, on one 513 x 513
    image: the card's logits against the CPU's (float32, TF32 off; within
    1e-4 of the largest |logit|), and the card's milliseconds an image."""
    import torch

    from cat_tpu_torch.metrics import MSC, DeepLabV2

    torch.manual_seed(0)
    msc = MSC(DeepLabV2(182, (3, 4, 23, 3), (6, 12, 18, 24))).eval()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in msc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    x = torch.randn(1, 3, DEEPLAB_HW, DEEPLAB_HW, generator=g)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = msc(x)
    cpu_s = time.perf_counter() - t0
    msc = msc.to(dev)
    xd = x.to(dev)
    with torch.no_grad():
        got = msc(xd).cpu()
        l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        ms = timed(lambda: msc(xd), l2.zero_, iters=5)
    del l2
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not torch.isfinite(got).all() or not err <= 1e-4 * scale:
        fail(f"14 (e) DeepLabV2/MSC: card against CPU, shape {tuple(got.shape)} "
             f"{tuple(ref.shape)}, max |err| {err:.3g} past 1e-4 of {scale:.3g}")
    log(f"14 (e) DeepLabV2 (ResNet-101 layout, 182 classes) under MSC on one {DEEPLAB_HW}^2 "
        f"image: logits {tuple(got.shape)}, card against CPU max |err| {err:.3g} (bound 1e-4 "
        f"of {scale:.3g}); {ms:.2f} ms an image on the card (the CPU {1e3 * cpu_s:.0f} ms) "
        f"[{card}]")
    return {"ms_per_image": ms, "max_abs_err": err, "max_abs_logit": scale,
            "cpu_ms": 1e3 * cpu_s, "logits": list(got.shape)}


def int8_unet_deeplab(dev, card, root, judge, stats, teacher_cfg, teacher_sd, verb_b, spade_b):
    """Phase 14: (a) the int8 conv at the flagship teacher's shapes, (b) the
    distill verb with the int8 teachers, (c) the GauGAN student recipe with
    int8_static and its teacher's convs, (d) the UNet, (e) DeepLab v2."""
    t_phase = time.perf_counter()
    convs, n_convs = teacher_convs(dev, teacher_cfg, teacher_sd)
    log(f"14 (a): the flagship teacher runs {n_convs} convs, {len(convs)} distinct")
    a = int8_conv_numbers(dev, card, convs)
    b, b_kern = int8_verbs(dev, card, root, verb_b, n_convs)
    c = int8_gaugan(dev, card, root, judge, stats, spade_b)
    d, d_kern = unet_distill(dev, card)
    e = deeplab(dev, card)
    return {"a": a, "b": b, "c": c, "d": d, "e": e, "b_kern": b_kern, "d_kern": d_kern,
            "teacher_convs": n_convs, "seconds": time.perf_counter() - t_phase}


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
    cuda_build.build_all(["gram", "instance_norm", "int8_conv", "group_norm"])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc, in parallel)")
    for name in ("gram", "instance_norm", "int8_conv", "group_norm"):
        with open(f"{cuda_build._lib_path(name)}.log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    teacher_cfg, teacher_sd, res = flagship()
    kern = check_kernels(dev, teacher_cfg, res.config, card)

    # --- 3. small steps against the CPU: batch 2, and batch 130 through the
    # f32 pair kernel (4 launches: two taps, teacher and student)
    ref_small = reference_check(dev)
    ref_pairs = reference_check(dev, REF_PAIRS_BATCH)
    if ref_pairs.get("f32tma_pairs", 0) != 4 or ref_pairs["gram"] != 4:
        fail(f"tiny f32 step at batch {REF_PAIRS_BATCH}: Gram launches {ref_pairs}, expected 4, "
             "all 'f32tma_pairs'")

    # --- 4. the flagship step
    log(f"flagship step at batch {BATCH} (as bench.py), {SIZE} px, bf16, packed blocks")
    times, counts, vals, mem = run_steps(dev, teacher_cfg, teacher_sd, res.config, False,
                                         1 + TIMED_STEPS)
    if counts["gram"] != 8 * (1 + TIMED_STEPS) or counts["gram_tma"] != counts["gram"]:
        fail(f"Gram kernels launched {counts['gram']} times in {1 + TIMED_STEPS} steps, "
             f"{counts['gram_tma']} of them the TMA kernel; expected 8 per step, all TMA")
    step_s = sum(times[1:]) / TIMED_STEPS
    log(f"flagship: {step_s * 1e3:.1f} ms/step, {BATCH / step_s:.1f} images/s "
        f"(warm-up step {times[0] * 1e3:.0f} ms), student {res.searched_macs} MACs, "
        f"peak memory {mem / 2**30:.2f} GiB, launches {counts}, losses {vals} [{card}]")
    gram_launches = counts["gram"]

    # --- 4b. the flagship step at batch 256: its Grams take the bf16 pair kernel
    times_p, counts_p, vals_p, mem_p = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                 False, PAIRS_STEPS,
                                                 batch_size=PAIRS_BATCH)
    if counts_p["gram"] != 8 * PAIRS_STEPS or counts_p["gram_tma_pairs"] != counts_p["gram"]:
        fail(f"batch-{PAIRS_BATCH} step: Gram kernels launched {counts_p['gram']} times in "
             f"{PAIRS_STEPS} steps, {counts_p['gram_tma_pairs']} of them the pair kernel; "
             "expected 8 per step, all 'tma_pairs'")
    step_p = sum(times_p[1:]) / (PAIRS_STEPS - 1)
    log(f"flagship at batch {PAIRS_BATCH}: {step_p * 1e3:.1f} ms/step, "
        f"{PAIRS_BATCH / step_p:.1f} images/s (warm-up step {times_p[0] * 1e3:.0f} ms), peak "
        f"memory {mem_p / 2**30:.2f} GiB, launches {counts_p}, losses {vals_p} [{card}]")

    # --- 4c. the same in float32: its Grams take the float32 pair kernel
    torch.cuda.empty_cache()
    times_q, counts_q, vals_q, mem_q = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                 False, PAIRS_STEPS,
                                                 batch_size=PAIRS_BATCH,
                                                 compute_dtype="float32")
    if counts_q["gram"] != 8 * PAIRS_STEPS or counts_q["gram_f32tma_pairs"] != counts_q["gram"]:
        fail(f"float32 batch-{PAIRS_BATCH} step: Gram kernels launched {counts_q['gram']} times "
             f"in {PAIRS_STEPS} steps, {counts_q['gram_f32tma_pairs']} of them the pair kernel; "
             "expected 8 per step, all 'f32tma_pairs'")
    step_q = sum(times_q[1:]) / (PAIRS_STEPS - 1)
    log(f"flagship at batch {PAIRS_BATCH}, float32 (TF32 off): {step_q * 1e3:.1f} ms/step, "
        f"{PAIRS_BATCH / step_q:.1f} images/s (warm-up step {times_q[0] * 1e3:.0f} ms), peak "
        f"memory {mem_q / 2**30:.2f} GiB, launches {counts_q}, losses {vals_q} [{card}]")

    # --- 5. the fused-norm step, timed as phase 4 is: 1 warm-up + 3 timed
    # steps, their median beside phase 4's
    times_f, counts_f, vals_f, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config, True,
                                             1 + TIMED_STEPS)
    n_f = 1 + TIMED_STEPS
    from cat_tpu_torch.models.generator import fused_norm_sites

    t_sites, s_sites = (len(fused_norm_sites(c, True, SIZE)) for c in (teacher_cfg, res.config))
    if (counts_f["instance_norm_act"] != (t_sites + s_sites) * n_f
            or counts_f["instance_norm_act_bwd"] != s_sites * n_f
            or counts_f["gram"] != 8 * n_f or counts_f["gram_tma"] != counts_f["gram"]):
        fail(f"fused step: launches {counts_f}, expected {t_sites + s_sites} norm forward "
             f"({t_sites} teacher, {s_sites} student), {s_sites} norm backward and 8 Gram (TMA) "
             "per step")
    med_4, med_5 = statistics.median(times[1:]), statistics.median(times_f[1:])
    log(f"fused-norm step: median {med_5 * 1e3:.1f} ms/step over steps 2-{n_f} (warm-up "
        f"{times_f[0] * 1e3:.0f} ms excluded; steps {[round(t * 1e3, 1) for t in times_f]}); "
        f"phase 4's plain-norm step in this call: median {med_4 * 1e3:.1f} ms "
        f"({100 * (med_5 / med_4 - 1):+.2f}%); launches {counts_f}, losses {vals_f} [{card}]")

    # --- 6. the distill verb and 7. evaluation, over one seeded dataset
    root = tempfile.mkdtemp(prefix="chip_smoke_verb_")
    try:
        t0 = time.perf_counter()
        write_verb_inputs(root, teacher_cfg, teacher_sd)
        log(f"verb: dataset ({VERB_IMAGES} PNGs per training side, {VAL_IMAGES}, {SIZE} px) "
            f"and checkpoints written in {time.perf_counter() - t0:.1f} s")
        native_built = native_status()
        verb, verb_kern = distill_verb(dev, card, root, native_built)
        log("verb: " + json.dumps(verb))
        ev = evaluation(dev, card, root)
        log("eval: " + json.dumps(ev))

        # --- 8. teacher training: tiny steps against the CPU, both teacher
        # recipes through the train verb, and 8b's teacher into the distill verb
        t0 = time.perf_counter()
        teacher_reference(dev)
        judge, stats = os.path.join(root, "judge.pth"), os.path.join(root, "real_stat_B.npz")
        h2z = train_h2z(dev, card, root, judge, stats)
        maps = train_maps(dev, card, root, judge)
        trained = os.path.join(root, "log_8b", "checkpoints")
        hand, _, _ = run_verb(root, "8d", [], "f32tma", dev, card, epochs=1,
                              teacher_g=os.path.join(trained, "latest_net_G_A.pth"),
                              teacher_d=os.path.join(trained, "latest_net_D_A.pth"))
        log(f"teacher 8d: the distill verb restored 8b's G_A and D_A and ran "
            f"{hand['steps']} steps, {hand['gram_launches']} Gram launches ({hand['gram_path']})")
        log("teacher: " + json.dumps({"8b": h2z, "8c": maps, "8d": hand,
                                      "seconds": time.perf_counter() - t0}))

        # --- 9. Cityscapes: card against CPU, the pix2pix recipes with mIoU,
        # the GauGAN teacher recipe
        t0 = time.perf_counter()
        city_a = city_reference(dev, card)
        write_city_inputs(root)
        log(f"city: inputs written in {time.perf_counter() - t0:.1f} s (9a included)")
        city_b, city_kern = city_pix2pix(dev, card, root, judge, stats)
        city_c = city_gaugan(dev, card, root, judge, stats)
        log("city: " + json.dumps({"9a": city_a, "9b": city_b, "9c": city_c,
                                   "seconds": time.perf_counter() - t0}))

        # --- 10. GauGAN distillation: tiny steps against the CPU, the 5.6e9
        # student recipe from 9c's teacher and D, its profile
        t0 = time.perf_counter()
        spade_a = spade_distill_reference(dev, card)
        spade_b, spade_kern = gaugan_student(dev, card, root, judge, stats)
        log("spade: " + json.dumps({"10a": spade_a, "10b": spade_b, "gram": spade_kern,
                                    "seconds": time.perf_counter() - t0}))

        # --- 11. the export verb on phase 6's and phase 10b's students
        t0 = time.perf_counter()
        exported = export_students(dev, card, root, spade_b["profile"]["latency_ms"])
        log("export: " + json.dumps({**exported, "seconds": time.perf_counter() - t0}))

        # --- 12. data parallelism: an NCCL world of one, two gloo ranks on
        # the card for phase 6's and 10b's recipes, a split evaluation
        dp = data_parallel(card, root, judge, stats)
        log("parallel: " + json.dumps(dp))

        # --- 13. spatial parallelism: tiny steps over 1 x 2 and 2 x 2 gloo
        # ranks, phase 6's recipe over two spatial ranks, the split norm
        sp = spatial_parallel(card, root, dp, teacher_cfg, res.config, judge, stats)
        log("spatial: " + json.dumps({k: v for k, v in sp.items() if k not in "bd"}))
        for part in "bd":
            log(f"spatial 13 ({part}): " + json.dumps({**sp[part], "ranks": [
                {k: v for k, v in rk.items() if k != "kern"} for rk in sp[part]["ranks"]]}))

        # --- 14. the int8 teacher (its convs at the flagship teacher's
        # shapes, the distill verb, the GauGAN recipe), the UNet, DeepLab v2
        q = int8_unet_deeplab(dev, card, root, judge, stats, teacher_cfg, teacher_sd, verb[1],
                              spade_b)
        log("int8: " + json.dumps({k: v for k, v in q.items() if not k.endswith("kern")}))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def row(name, src, replaces, launches, k, per):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": k["err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": "bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
                "library_ms": k["library_ms"], "per": per}

    gram_src = ("cat_tpu_torch/csrc/gram.cu", "cat_tpu/distill/ka.py:51")
    per = f"one training step's launches at batch {BATCH}, bf16"
    pairs = {d: kern[("gram_pairs", d)] for d in ("bfloat16", "float32")}
    rows = [
        {**row("gram", *gram_src, gram_launches, kern[("gram", "bfloat16")], per),
         "mma_sync_ms": kern[("gram", "bfloat16")]["mma_sync_ms"],
         "bound_full_square_ms": kern[("gram", "bfloat16")]["bound_full_square_ms"],
         "pairs_b256": pairs["bfloat16"]},
    ]
    # the norm kernel, forward and backward, in both dtypes: six sites at
    # batch 128; launches: phase 5's bf16 steps, phase 3's float32 tiny step
    norm_src = "cat_tpu_torch/csrc/instance_norm.cu"
    f32_per = (f"one call at each of the six sites at batch {BATCH}, float32; launches: phase "
               f"3's float32 step at batch 2 (unpacked blocks: every instance norm fused)")
    for name, key, launches, replaces in (
            ("instance_norm_act", "instance_norm_act", "instance_norm_act",
             "cat_tpu/ops/pallas_norm.py:35"),
            ("instance_norm_act backward", "instance_norm_act_bwd", "instance_norm_act_bwd",
             "cat_tpu/ops/pallas_norm.py:169 (_fused_bwd, XLA's)")):
        for dname, n, text in (("bfloat16", counts_f[launches], per + f" (phase 5, {n_f} steps)"),
                               ("float32", ref_small[launches], f32_per)):
            k = kern[(key, dname)]
            rows.append({**row(f"{name} ({dname})", norm_src, replaces, n, k, text),
                         **({"two_pass_ms": k["two_pass_ms"]} if "two_pass_ms" in k else {}),
                         "sites": k["paths"]})
    # the same kernels at every site phase 5 fuses (trunk, blocks, upsampling)
    for direction, name, launches, replaces in (
            ("forward", "instance_norm_act", "instance_norm_act", "cat_tpu/ops/pallas_norm.py:35"),
            ("backward", "instance_norm_act backward", "instance_norm_act_bwd",
             "cat_tpu/ops/pallas_norm.py:169 (_fused_bwd, XLA's)")):
        k = kern["norm_sites"][direction]
        rows.append({**row(f"{name} (bfloat16, every fused site)", norm_src, replaces,
                           counts_f[launches], k,
                           f"one step's {k['calls']} calls at the flagship's fused sites at batch "
                           f"{BATCH}, bf16, each shape timed alone (phase 2); launches: phase 5's "
                           f"{n_f} steps"),
                     "layers": k["layers"]})
    # ADM's GroupNorm chain at every site of its cell (phase 2); launches: a
    # step of the cell's program in phase 2, by the counters
    for direction, name in (("forward", "group_norm_act"),
                            ("backward", "group_norm_act backward")):
        k = kern["group_norm_sites"][direction]
        rows.append({**row(f"{name} (bfloat16, every ADM site, NHWC)",
                           "cat_tpu_torch/csrc/group_norm.cu",
                           "none (ADM's GroupNorm is XLA's in the JAX package)",
                           kern["adm_step"][direction], k,
                           f"one step's {k['calls']} calls at the ADM cell's sites at batch "
                           f"{ADM_BATCH}, bf16, channels innermost, each shape timed alone "
                           f"(phase 2); launches: a step of the cell's program, counted over "
                           f"phase 2's {ADM_STEPS}"),
                     "nchw_kernels_ms": k["nchw_ms"],
                     "big_slabs_pct_of_bound": 100 * k["big_bytes_ms"] / k["big_ms"],
                     "launches_by_layout": kern["adm_step"]["by_layout"],
                     "transposes_a_step": kern["adm_step"]["transposes"],
                     "shapes": k["shapes"]})
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
                 "fma_ms": f32["fma_ms"], "bound_full_square_ms": f32["bound_full_square_ms"],
                 "pairs_b256": pairs["float32"]})
    # the float32 kernel on the pix2pix Cityscapes student's own taps (phase 9b)
    rows.append({**row("gram (pix2pix Cityscapes student, float32)", *gram_src,
                       city_b["student"]["gram_launches"], city_kern,
                       f"one training step's launches at batch 80, float32, on the run's own "
                       f"taps (f32tma kernel; phase 9b's {city_b['student']['steps']} steps)"),
                 "fma_ms": city_kern["fma_ms"],
                 "bound_full_square_ms": city_kern["bound_full_square_ms"]})
    # the float32 kernel on the GauGAN student recipe's own six taps (phase 10b)
    rows.append({**row("gram (GauGAN student, float32, B = 16)", *gram_src,
                       spade_b["gram_launches"], spade_kern,
                       f"one training step's launches at batch 16, float32, on the run's own "
                       f"taps {', '.join(SPADE_TAPS)} of teacher and student, F = "
                       f"{spade_kern['f']} (f32tma kernel; phase 10b's {spade_b['steps']} "
                       f"steps)"),
                 "fma_ms": spade_kern["fma_ms"],
                 "bound_full_square_ms": spade_kern["bound_full_square_ms"]})
    # the pair kernels: one call at B = 256 on the teacher tap's F; launches
    # from phase 4b's (bf16) and 4c's (float32) steps at batch 256
    for dname, n, phase in (("bfloat16", counts_p["gram_tma_pairs"], "4b"),
                            ("float32", counts_q["gram_f32tma_pairs"], "4c")):
        k = pairs[dname]
        rows.append(row(f"gram pairs ({dname}, B > 128)", *gram_src, n, k,
                        f"one call at B = {k['b']}, F = {k['f']} (the teacher tap); launches: "
                        f"phase {phase}'s {PAIRS_STEPS} steps at batch {PAIRS_BATCH}"))
    # phase 13: the float32 kernel on 13 (b)'s half-height taps (rank 0's
    # launches), and the split norm's entry points (13 (c)'s times at the
    # flagship's shapes cut in two heights, bf16; launches: the fused tiny
    # distiller over two spatial ranks)
    sp_k, sp_rank0 = sp["b"]["ranks"][0]["kern"], sp["b"]["ranks"][0]
    rows.append({**row("gram (spatial shards, float32)", *gram_src,
                       sp_rank0["counts"]["gram"], sp_k,
                       f"one training step's launches on one of two spatial ranks at batch "
                       f"{VERB_BATCH}, float32, on the run's own (80, F/2) taps (f32tma kernel; "
                       f"phase 13 (b)'s {sp_rank0['steps']} steps)"),
                 "fma_ms": sp_k["fma_ms"], "bound_full_square_ms": sp_k["bound_full_square_ms"]})
    # the float32 kernel on 13 (d)'s GauGAN half-height taps (rank 0's launches)
    sd_k, sd_rank0 = sp["d"]["ranks"][0]["kern"], sp["d"]["ranks"][0]
    rows.append({**row("gram (GauGAN spatial shards, float32, B = 16)", *gram_src,
                       sd_rank0["counts"]["gram"], sd_k,
                       f"one training step's launches on one of two spatial ranks at batch "
                       f"{GAUGAN_BATCH}, float32, on the run's own six (16, F/2) taps "
                       f"{', '.join(SPADE_TAPS)} of teacher and student, F/2 = {sd_k['f']} "
                       f"(f32tma kernel; phase 13 (d)'s {sd_rank0['steps']} steps)"),
                 "fma_ms": sd_k["fma_ms"], "bound_full_square_ms": sd_k["bound_full_square_ms"]})
    fused_counts = sp["a"]["1x2"]["counts"]["distill_fused"]
    for part, entry_point in (("stats", "cat_inorm_stats_*"), ("apply", "cat_inorm_apply_*")):
        k = {**sp["c"][part], "library_ms": None}
        rows.append(row(f"instance_norm split planes: {part} ({entry_point})",
                        "cat_tpu_torch/csrc/instance_norm.cu", "cat_tpu/ops/pallas_norm.py:35",
                        fused_counts[f"split_{part}"], k,
                        f"one call at each of the flagship's six ConvNormAct shapes cut in two "
                        f"heights, batch {BATCH}, bf16; launches: phase 13 (a)'s fused tiny "
                        f"distiller over two spatial ranks, 2 steps"))
    # phase 14: the Gram on the int8 teacher's and the UNet's taps, and the
    # int8 conv's two paths (not TPU kernels: XLA's conv in the JAX package)
    b8 = q["b"]["int8"]
    rows.append({**row("gram (int8 teacher, distill verb, bf16)", *gram_src, b8["gram_launches"],
                       q["b_kern"], f"one training step's launches at batch {VERB_BATCH}, bf16, "
                       f"on the int8 run's own taps (tma kernel; phase 14 (b)'s {b8['steps']} "
                       f"steps; 14 (c)'s GauGAN run: {q['c']['gram_launches']} f32tma launches "
                       f"in {q['c']['steps']} steps)"),
                 "bound_full_square_ms": q["b_kern"]["bound_full_square_ms"]})
    d_k = q["d_kern"]
    rows.append({**row("gram (UNet GenericDistiller, bf16, B = 32)", *gram_src,
                       q["d"]["gram_launches"], d_k,
                       f"one training step's launches at batch {UNET_BATCH}, bf16, on the run's "
                       f"own taps down1, mid, up1 of teacher and student, F = {d_k['f']} (tma "
                       f"kernel; phase 14 (d)'s {q['d']['steps']} steps)"),
                 "bound_full_square_ms": d_k["bound_full_square_ms"]})
    for path, name, src in (("intmm", "int8_conv (im2col + torch._int_mm, groups 1)",
                             "cat_tpu_torch/ops/quant.py"),
                            ("grouped", "int8_conv (direct kernel, groups > 1)",
                             "cat_tpu_torch/csrc/int8_conv.cu")):
        k = q["a"][path]
        rows.append({**row(name, src, "not a TPU kernel: cat_tpu/ops/quant.py:85 hands the "
                           "int8 conv to XLA", b8["int8_launches"][path], k,
                           f"the {k['convs']} {path} convs of one flagship teacher forward at "
                           f"batch {VERB_BATCH}, bf16 ({k['shapes']} shapes, phase 14 (a)), "
                           f"quantisation and dequantisation included; library_ms: cuDNN's bf16 "
                           f"conv of the same shapes; launches: phase 14 (b)'s int8 run, "
                           f"{b8['steps']} steps"),
                     **{key: k[key] for key in ("quant_ms", "conv_ms", "dequant_ms")}})
    k, c = q["c"]["convs"]["grouped"], q["c"]
    rows.append({**row("int8_conv (direct kernel, groups > 1, float32 store)",
                       "cat_tpu_torch/csrc/int8_conv.cu", "not a TPU kernel: "
                       "cat_tpu/ops/quant.py:85 hands the int8 conv to XLA",
                       c["int8_launches"]["grouped"], k,
                       f"the {k['convs']} grouped convs of one GauGAN teacher forward at batch "
                       f"{GAUGAN_BATCH}, 512x256, float32 ({k['shapes']} shapes, phase 14 (c)), "
                       f"quantisation and dequantisation included; library_ms: cuDNN's float32 "
                       f"conv (TF32 off) of the same shapes; launches: phase 14 (c)'s run, "
                       f"{c['steps']} steps, the first one's teacher forward calibrating"),
                 **{key: k[key] for key in ("quant_ms", "conv_ms", "dequant_ms")}})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
