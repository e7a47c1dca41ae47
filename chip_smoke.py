"""Drive the PyTorch/CUDA port (``cat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

  1. device: requires CUDA; prints the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
  2. kernels: builds the hand-written CUDA kernels from ``cat_tpu_torch/csrc``
     (one nvcc per source, in parallel), then holds each against its plain
     PyTorch version in bf16 and f32 at the flagship step's shapes, and times
     kernel, plain version, one-call PyTorch yardstick and the bytes bound;
  3. reference: one float32 KA-distillation step at a tiny size on the card
     (kernels) and on the CPU (plain versions), losses compared;
  4. flagship: the horse2zebra KA-distillation step of ``bench.py`` (teacher
     ngf 64 / r6 / kernels 1,3,5; student shrunk to 2.6e9 MACs; 256 px;
     unaligned lsgan + KA over encode, block2, block5, block8; bf16 compute,
     float32 masters; packed blocks) at full width: 1 warm-up + 3 timed steps,
     the Gram kernel launched 8 times per step;
  5. fused norms: the same step with ``fused_norms=True`` for 2 steps, the
     norm kernel launched once per ConvNormAct (6 per step).

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
    # --- Gram: one operand per launch; per tap a teacher and a student one
    bc = t_channels[-1], s_channels[-1]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0}
        for who, c in zip(("teacher", "student"), bc):
            f = 64 * 64 * c
            x = torch.relu(torch.randn(BATCH, f, generator=gen, device=dev)).to(dtype)
            got, ref = ka.gram_cuda(x), ka.gram_plain(x)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())  # f32 sums in another order
            if not err <= tol or not torch.isfinite(got).all():
                fail(f"gram {who} {dname} {tuple(x.shape)}: max |err| {err:g} > {tol:g}")
            xf = x.float()
            ms = timed(lambda: ka.gram_cuda(x), flush=flush)
            plain = timed(lambda: ka.gram_plain(x), flush=flush)
            lib = timed(lambda: torch.matmul(xf, xf.T), flush=flush)
            bytes_ms = 1e3 * (BATCH * f * x.element_size() + BATCH * BATCH * 4) / HBM_BYTES_PER_S
            ops_ms = 1e3 * 2 * BATCH * BATCH * f / PEAK_FLOPS[dname]
            bound = max(bytes_ms, ops_ms)
            log(f"gram {who:7s} {dname:8s} B={BATCH} F={f}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, torch.matmul(f32) {lib:.4f} ms, bound {bound:.4f} ms, "
                f"max|err| {err:.3g} (tol {tol:.3g}) [{card}]")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[k] += 4 * v  # four taps per step
            tot["err"] = max(tot["err"], err)
        out[("gram", dname)] = tot

    # --- instance norm + affine + relu at stem / down0 / down1, both nets
    planes = [(c, SIZE >> j) for channels in (t_channels, s_channels)
              for j, c in enumerate(channels)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0, "err": 0.0,
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
            # one read and one write; ~10 flops per element on CUDA cores
            bytes_ms = 1e3 * 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
            ops_ms = 1e3 * 10 * x.numel() / PEAK_FLOPS["float32"]
            bound = max(bytes_ms, ops_ms)
            log(f"instance_norm_act {dname:8s} {tuple(x.shape)}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {bound:.4f} ms, max|err| {float(diff.max()):.3g} "
                f"(tol rtol {rtol:g} + atol {atol:g}) [{card}]")
            for k, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
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

    ka.launches = 0
    inorm.launches = 0
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = dist.train_step(state, tparams, batch, LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {"gram": ka.launches, "instance_norm_act": inorm.launches}

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


def _stdlib_profile() -> None:
    """Import the standard library's ``profile`` module.  The repository
    root holds ``profile.py`` (the JAX package's profile verb), which would
    shadow it; torch.profiler reaches ``profile`` through cProfile."""
    root = os.path.dirname(os.path.abspath(__file__))
    saved = sys.path[:]
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != root]
    try:
        import cProfile  # noqa: F401
        import profile as _profile  # noqa: F401
    finally:
        sys.path[:] = saved


def profile(step, n, card):
    """Device time of ``n`` steps by kernel group, from torch.profiler;
    returns the device-busy milliseconds per step (None if the profiler saw
    no device time).  The profiler slows the host, so its wall time is no
    measure of the idle share."""
    _stdlib_profile()
    import torch
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
    if counts["gram"] != 8 * (1 + TIMED_STEPS):
        fail(f"Gram kernel launched {counts['gram']} times in {1 + TIMED_STEPS} steps, "
             "expected 8 per step")
    step_s = sum(times[1:]) / TIMED_STEPS
    log(f"flagship: {step_s * 1e3:.1f} ms/step, {BATCH / step_s:.1f} images/s "
        f"(warm-up step {times[0] * 1e3:.0f} ms), student {res.searched_macs} MACs, "
        f"peak memory {mem / 2**30:.1f} GiB, launches {counts}, losses {vals} [{card}]")
    if busy_ms is not None:
        log(f"flagship: device idle {100 * max(0.0, 1 - busy_ms / (step_s * 1e3)):.1f}% "
            "(profiled device-busy time per step against the unprofiled step time)")
    gram_launches = counts["gram"]

    # --- 5. the fused-norm step
    times_f, counts_f, vals_f, _, _ = run_steps(dev, teacher_cfg, teacher_sd, res.config,
                                                True, FUSED_STEPS, card)
    if counts_f["instance_norm_act"] != 6 * FUSED_STEPS or counts_f["gram"] != 8 * FUSED_STEPS:
        fail(f"fused step: launches {counts_f}, expected 6 norm and 8 Gram per step")
    log(f"fused-norm step: {sum(times_f) / FUSED_STEPS * 1e3:.1f} ms/step (first step "
        f"included), launches {counts_f}, losses {vals_f} [{card}]")

    sources = {"gram": ("cat_tpu_torch/csrc/gram.cu", "cat_tpu/distill/ka.py:51",
                        gram_launches),
               "instance_norm_act": ("cat_tpu_torch/csrc/instance_norm.cu",
                                     "cat_tpu/ops/pallas_norm.py:35",
                                     counts_f["instance_norm_act"])}
    rows = []
    for name, (src, replaces, launches) in sources.items():
        k = kern[(name, "bfloat16")]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": k["err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
            "library_ms": k["library_ms"],
            "per": f"one training step's launches at batch {BATCH}, bf16",
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
