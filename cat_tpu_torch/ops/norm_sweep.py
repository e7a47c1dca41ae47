"""Time plan variants of the norm kernels at the flagship's planes, on one GPU.

    python -m cat_tpu_torch.ops.norm_sweep

For each dtype (bf16, float32) and each of the flagship step's three plane
sizes at batch 128 with the largest channel count of its sites (64 x 256²,
128 x 128², 256 x 64²), the forward kernel and the backward kernel are
timed on every ``NormPlan`` a CTA can hold: 1, 2, 4 or 8 CTAs a plane, the
slice cut into 1, 2, 4 or 8 bulk copies, and small planes packed 2, 4 or 8
to a CTA.  Each variant is checked against the plain version and timed with
CUDA events after an L2 flush; the lines are sorted fastest first, the one
``norm_plan`` picks marked, with the card's name and power limit.  The
constants of ``norm_plan`` rest on this sweep.
"""

from __future__ import annotations

import subprocess

import torch

from cat_tpu_torch.ops import instance_norm as tin
from cat_tpu_torch.ops.instance_norm import NormPlan

SHAPES = [(128, 64, 256, 256), (128, 128, 128, 128), (128, 256, 64, 64)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _timed(fn, flush, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, each after
    an L2 flush and a device-side sleep (so the whole call is enqueued before
    the device reaches it)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(4_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def variants(hw: int, itemsize: int, arrays: int):
    """Every plan a CTA can hold for planes of ``hw`` values: k CTAs a plane
    with slices of 8-200 KiB cut into 1-8 chunks, and planes of at most 32
    KiB packed 2, 4 or 8 to a CTA."""
    vec = 16 // itemsize
    out = []
    for k in (1, 2, 4, 8):
        slice_ = tin._round_up(-(-hw // k), vec)
        nbytes = slice_ * itemsize * arrays
        if nbytes > 200 << 10 or (k > 1 and nbytes < 8 << 10):
            continue
        for nch in (1, 2, 4, 8):
            out.append(NormPlan("cluster" if k > 1 else "one_cta", k, 1, slice_,
                                tin._round_up(-(-slice_ // nch), vec)))
    plane = hw * itemsize * arrays
    out += [NormPlan("one_cta", 1, ppc, hw, hw) for ppc in (2, 4, 8)
            if plane <= 32 << 10 and ppc * plane <= 128 << 10]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("norm_sweep needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    l2 = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            sc = torch.rand(shape[1], generator=gen, device=dev) + 0.5
            bi = torch.randn(shape[1], generator=gen, device=dev)
            hw, size = shape[2] * shape[3], x.element_size()
            _, m, r = tin.forward_cuda(x, sc, bi)
            ref = tin.instance_norm_act_plain(x, sc, bi).float()
            ref_dx = tin.instance_norm_act_backward_plain(x, g, sc, bi, 1e-5, "relu",
                                                          (m, r))[0].float()
            rows = []
            for kind, arrays in (("forward", 1), ("backward", 2)):
                picked = tin.norm_plan(hw, size, arrays)
                for p in variants(hw, size, arrays):
                    if kind == "forward":
                        def fn(p=p):
                            return tin.forward_cuda(x, sc, bi, plan=p)
                        err = float((fn()[0].float() - ref).abs().max())
                    else:
                        def fn(p=p):
                            return tin.instance_norm_act_backward_cuda(x, g, m, r, sc, bi,
                                                                       plan=p)
                        err = float((fn()[0].float() - ref_dx).abs().max())
                    ms = _timed(fn, l2.zero_)
                    bound = 1e3 * (1 + arrays) * x.numel() * size / HBM_BYTES_PER_S
                    rows.append((kind, ms, p, err, bound, p == picked))
            for kind, ms, p, err, bound, mine in sorted(rows, key=lambda t: (t[0], t[1])):
                print(f"{str(dtype)[6:]:8s} {shape} {kind:8s} k={p.k} ppc={p.ppc} "
                      f"slice={p.slice} chunk={p.chunk}: {ms:.4f} ms ({100 * bound / ms:.1f}% "
                      f"of bound), max|err| {err:.3g}{'  <- norm_plan' if mine else ''} [{card}]",
                      flush=True)
            del x, g, ref, ref_dx


if __name__ == "__main__":
    main()
