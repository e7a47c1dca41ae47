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
     block) in place and on a padded copy (F % 8 != 0), checked only;
  3. reference: one float32 KA-distillation step at a tiny size on the card
     (kernels) and on the CPU (plain versions), losses compared, at batch 2
     and at batch 130 (4 launches of the float32 pair kernel);
  4. flagship: the horse2zebra KA-distillation step of ``bench.py`` (teacher
     ngf 64 / r6 / kernels 1,3,5; student shrunk to 2.6e9 MACs; 256 px;
     unaligned lsgan + KA over encode, block2, block5, block8; bf16 compute,
     float32 masters; packed blocks) at full width: 1 warm-up + 3 timed steps,
     the Gram's TMA kernel launched 8 times per step; 4b: the same step at
     batch 256, 1 warm-up + 1 timed step, the bf16 pair kernel launched 8
     times per step; 4c: 4b in float32 (TF32 off), the float32 pair kernel
     launched 8 times per step;
  5. fused norms: the same step with ``fused_norms=True`` for 2 steps, the
     norm kernel launched once per ConvNormAct (6 per step);
  6. distill verb: ``entry.distill_main`` with the flags of
     ``scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh`` (batch
     80, 2.6e9-MAC student, KA, lsgan, pretrained-G transfer and D restore)
     over a seeded unaligned dataset of 256x256 PNGs (160 per training side,
     120 in valA and 140 in valB, horse2zebra's test split), 8 steps, three
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
     memory.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

BATCH = 128  # bench.py's batch
SIZE = 256
TIMED_STEPS = 3
FUSED_STEPS = 2
LR = 2e-4
VERB_BATCH = 80  # the student recipe's batch
VERB_IMAGES = 160  # per side: 2 steps per epoch
VERB_EPOCHS = 4
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


def reference_check(dev, batch=2):
    """One float32 step at a tiny size on the card and on the CPU, from the
    same weights and batch: the kernels in context against the plain
    versions.  Returns the card step's Gram launches by path (batch > 128:
    the f32 pair kernel; the CPU takes ``gram_pairs_plain``)."""
    import torch

    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NLayerDiscriminatorConfig
    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.models.generator import InceptionGenerator

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
        _, m = dist.train_step(state, tp, {k: v.to(d) for k, v in batch_.items()}, LR)
        if d == dev:
            torch.cuda.synchronize()
            counts = {"gram": ka.launches, **{p: n for p, n in ka.path_launches.items() if n}}
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


def run_steps(dev, teacher_cfg, teacher_sd, student_cfg, fused, n_steps, card,
              profile_steps=0, batch_size=BATCH, compute_dtype="bfloat16"):
    import torch

    from cat_tpu_torch.distill import ka
    from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
    from cat_tpu_torch.ops import instance_norm as inorm

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
    inorm.launches = 0
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = dist.train_step(state, tparams, batch, LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"gram": ka.launches, "gram_tma": ka.path_launches["tma"],
              "gram_tma_pairs": ka.path_launches["tma_pairs"],
              "gram_f32tma_pairs": ka.path_launches["f32tma_pairs"],
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


def run_verb(root, label, extra, expect_path, dev, card, epochs=VERB_EPOCHS):
    """``entry.distill_main`` with the recipe's flags, ``extra`` and
    ``epochs`` epochs; checks launches, checkpoints, reload and losses, and
    returns the run's numbers and the distill run."""
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
            *RECIPE, "--nepochs", str(epochs), "--save_epoch_freq", str(epochs), *extra]
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

    n_steps = epochs * VERB_IMAGES // VERB_BATCH
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
    cpu_judge, card_judge = load_inception(judge), load_inception(judge, device=dev)
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

    # --- 3. small steps against the CPU: batch 2, and batch 130 through the
    # f32 pair kernel (4 launches: two taps, teacher and student)
    reference_check(dev)
    ref_pairs = reference_check(dev, REF_PAIRS_BATCH)
    if ref_pairs.get("f32tma_pairs", 0) != 4 or ref_pairs["gram"] != 4:
        fail(f"tiny f32 step at batch {REF_PAIRS_BATCH}: Gram launches {ref_pairs}, expected 4, "
             "all 'f32tma_pairs'")

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

    # --- 4b. the flagship step at batch 256: its Grams take the bf16 pair kernel
    times_p, counts_p, vals_p, mem_p, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                    False, PAIRS_STEPS, card,
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
    times_q, counts_q, vals_q, mem_q, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                    False, PAIRS_STEPS, card,
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

    # --- 5. the fused-norm step
    times_f, counts_f, vals_f, _, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                True, FUSED_STEPS, card)
    if (counts_f["instance_norm_act"] != 6 * FUSED_STEPS or counts_f["gram"] != 8 * FUSED_STEPS
            or counts_f["gram_tma"] != counts_f["gram"]):
        fail(f"fused step: launches {counts_f}, expected 6 norm and 8 Gram (TMA) per step")
    log(f"fused-norm step: {sum(times_f) / FUSED_STEPS * 1e3:.1f} ms/step (first step "
        f"included), launches {counts_f}, losses {vals_f} [{card}]")

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
                 "fma_ms": f32["fma_ms"], "bound_full_square_ms": f32["bound_full_square_ms"],
                 "pairs_b256": pairs["float32"]})
    # the pair kernels: one call at B = 256 on the teacher tap's F; launches
    # from phase 4b's (bf16) and 4c's (float32) steps at batch 256
    for dname, n, phase in (("bfloat16", counts_p["gram_tma_pairs"], "4b"),
                            ("float32", counts_q["gram_f32tma_pairs"], "4c")):
        k = pairs[dname]
        rows.append(row(f"gram pairs ({dname}, B > 128)", *gram_src, n, k,
                        f"one call at B = {k['b']}, F = {k['f']} (the teacher tap); launches: "
                        f"phase {phase}'s {PAIRS_STEPS} steps at batch {PAIRS_BATCH}"))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
