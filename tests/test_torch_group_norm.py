"""ADM's GroupNorm chain (``cat_tpu_torch/ops/group_norm.py``): the plain
twin and its closed-form backward on the CPU, the kernels of
``csrc/group_norm.cu`` against them on the card.

The CPU tests hold the closed-form backward to autograd of the plain
forward in float64 (to ~1e-12: the same arithmetic in another order), the
plain forward to the chain ``models/adm.py`` ran before the kernel
(``F.group_norm`` in float32, then ``addcmul`` and SiLU) in float32, the
kernels' names to what the benchmark's readers look for, and the plans to
what the kernels take.  The tests marked ``cuda`` skip without an NVIDIA
GPU (a CUDA kernel has no CPU mode); the file imports neither JAX nor the
JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_group_norm.py
"""

import collections
import os
import re

import pytest
import torch
import torch.nn.functional as F

from benchmark.metrics import group_norm_ms_per_step
from benchmark.yardstick.kernel_groups import OTHER, group_of
from cat_tpu_torch import import_stdlib_profile
from cat_tpu_torch.models.adm import ADMConfig, group_norm_sites
from cat_tpu_torch.ops import group_norm as gn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "cat_tpu_torch", "csrc", "group_norm.cu")

# the four sites of an ADM net: in_layers.0 and out.0 (GN + SiLU),
# out_layers.0 (GN + scale-shift + SiLU), attn.norm (GN alone); and the
# scale-shift without SiLU, which the kernels also take
VARIANTS = [(False, True), (True, True), (False, False), (True, False)]  # (scale-shift, SiLU)
# (shape, groups): C/G 1 to 16, an odd H·W, a (B, C, T) attention input
SHAPES = [((2, 32, 3, 5), 32), ((2, 64, 7, 7), 32), ((3, 48, 4, 6), 3), ((2, 64, 9), 4),
          ((1, 8, 5, 5), 2)]


def _inputs(shape, dtype, emb, gen):
    c = shape[1]
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + 1
    g = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(c, generator=gen, dtype=torch.float64)
    e = torch.randn(shape[0], 2 * c, generator=gen, dtype=torch.float64) * 0.5 if emb else None
    affine = torch.float64 if dtype == torch.float64 else torch.float32  # the masters' dtype
    return (x.to(dtype), g.to(dtype), w.to(affine), b.to(affine),
            None if e is None else e.to(dtype))


@pytest.mark.parametrize("emb,silu", VARIANTS)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_backward_matches_autograd_in_float64(shape, groups, emb, silu):
    """``group_norm_act_backward_plain``, and ``group_norm_act``'s backward
    on the CPU, against autograd of ``group_norm_act_plain`` in float64."""
    x, g, w, b, e = _inputs(shape, torch.float64, emb, torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, e) if t is not None]
    ref = torch.autograd.grad(
        gn.group_norm_act_plain(leaves[0], groups, leaves[1], leaves[2], 1e-5,
                                leaves[3] if emb else None, silu), leaves, g)
    got = gn.group_norm_act_backward_plain(x, g, groups, w, b, 1e-5, e, silu)
    assert (got[3] is None) == (not emb)
    fn = [t.clone().requires_grad_(True) for t in leaves]
    via = torch.autograd.grad(gn.group_norm_act(fn[0], groups, fn[1], fn[2], 1e-5,
                                                fn[3] if emb else None, silu), fn, g)
    for a, v, r in zip(got, via, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.allclose(a, r, rtol=1e-10, atol=1e-11)
        assert torch.allclose(v, r, rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("emb,silu", VARIANTS)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_forward_matches_the_old_chain(shape, groups, emb, silu):
    """The twin against what ``GroupNorm32`` and ``ResBlock`` ran before
    the kernel, in float32: ``F.group_norm`` on the float32 input, the
    scale-shift by ``addcmul`` on the chunked (B, 2C) vector, then SiLU
    (the same float32 arithmetic; ~1 ulp apart where the twin's
    ``y·(1 + s) + t`` rounds once more than ``addcmul``)."""
    x, _, w, b, e = _inputs(shape, torch.float32, emb, torch.Generator().manual_seed(5))
    y = F.group_norm(x.float(), groups, w, b, 1e-5)
    if emb:
        spatial = [1] * (x.dim() - 2)
        scale, shift = e.reshape(x.shape[0], -1, *spatial).chunk(2, 1)
        y = torch.addcmul(shift, y, 1 + scale)
    if silu:
        y = F.silu(y)
    got = gn.group_norm_act_plain(x, groups, w, b, 1e-5, e, silu)
    assert got.dtype == torch.float32
    assert torch.allclose(got, y, rtol=1e-6, atol=1e-6)


def test_twin_rounds_once_and_keeps_the_masters():
    """A bf16 input: ``F.group_norm`` sees the float32 activation and the
    affine's own float32 tensors (no copy), and the output is the float32
    chain rounded once."""
    x, _, w, b, e = _inputs((2, 64, 4, 4), torch.bfloat16, True,
                            torch.Generator().manual_seed(7))
    seen = []
    orig = F.group_norm

    def spy(xx, groups, ww, bb, eps):
        seen.append((xx.dtype, ww, bb))
        return orig(xx, groups, ww, bb, eps)

    F.group_norm = spy
    try:
        got = gn.group_norm_act(x, 32, w, b, 1e-5, e, True)
    finally:
        F.group_norm = orig
    assert len(seen) == 1 and seen[0][0] == torch.float32
    assert seen[0][1] is w and seen[0][2] is b
    full = gn.group_norm_act_plain(x.float(), 32, w, b, 1e-5, e.float(), True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, full.to(torch.bfloat16))


def _kernel_declarations():
    """Each ``__global__`` kernel of the source: (name, parameter list)."""
    src = open(SOURCE).read()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(([^)]*)\)")
    return [(m.group(1), " ".join(m.group(2).split())) for m in pat.finditer(src)]


def test_kernel_names_are_read_by_group_norm_ms_and_fall_in_other():
    """Every kernel's name holds ``group_norm``, which the benchmark's
    ``group_norm_ms_per_step`` reads, and its demangled form (template
    argument and parameter types included; the parameter names too, to be
    safe) holds none of the substrings that would put it in another kernel
    group than ``other``."""
    decls = _kernel_declarations()
    assert len(decls) == 7
    for name, params in decls:
        assert "group_norm" in name
        for t in ("__nv_bfloat16", "float"):
            demangled = f"void (anonymous namespace)::{name}<{t}>({re.sub(r'\bT\b', t, params)})"
            assert any(k in demangled.lower() for k in group_norm_ms_per_step.NAMES)
            assert group_of(demangled) == OTHER, demangled


def _adm_shapes():
    """(C, side) -> sites a net, for the ADM cell's teacher and student."""
    out = {}
    for mc in (256, 128):
        out[mc] = collections.Counter((c, s) for _, c, s in
                                      group_norm_sites(ADMConfig(model_channels=mc)))
    return out


def _assert_kernels_take(plan, cpg, hw, itemsize, arrays, vec=True):
    """``plan`` is one the kernels take: on the split path pieces that
    cover a channel (16-byte multiples with ``vec``); staged, 16-byte
    accesses, 1-16 CTAs a slab forward and 1-8 backward covering it with
    slices of whole channels or equal pieces of one, at most 64 channels, 4
    bulk copies and 64 KiB a CTA."""
    v = 16 // itemsize
    if plan.path == "split":
        assert plan.k == 0 and plan.slice > 0 and plan.pieces == -(-hw // plan.slice)
        assert not vec or plan.slice % v == 0
        return
    m = cpg * hw
    whole = plan.pieces == 1 and plan.slice % hw == 0
    piece = plan.pieces > 1 and plan.slice * plan.pieces == hw
    assert hw % v == 0 and cpg <= 64 and plan.slice % v == 0 and (whole or piece)
    assert plan.chunk > 0 and plan.chunk % v == 0 and -(-plan.slice // plan.chunk) <= 4
    assert 1 <= plan.k <= (16 if arrays == 1 else 8)
    assert (plan.k - 1) * plan.slice < m <= plan.k * plan.slice
    assert plan.slice * itemsize * arrays <= 64 << 10
    assert (plan.path == "cluster") == (plan.k > 1)


def test_plans_take_the_adm_slabs_on_chip():
    """At every slab of the cell's teacher (forward) and student (forward
    and backward), bf16 at 256 px, the plan stages the slab in one CTA or a
    cluster that the kernels take (at most 16 CTAs forward, 8 backward), at
    most 64 KiB a CTA; only the teacher's 2 MiB forward slabs (past 16 such
    CTAs) and the student's backward slabs past 8 take the split path."""
    split = []
    for mc, shapes in _adm_shapes().items():
        for c, side in shapes:
            cpg, hw = c // 32, side * side
            for arrays in ((1,) if mc == 256 else (1, 2)):
                plan = gn.group_norm_plan(cpg, hw, 2, arrays)
                _assert_kernels_take(plan, cpg, hw, 2, arrays)
                if plan.path == "split":
                    split.append((mc, c, side, arrays))
                    continue
                assert plan.path in ("cta", "cluster") and plan.k <= (16 if arrays == 1 else 8)
                assert plan.slice * 2 * arrays <= 64 << 10
    assert sorted(split) == [(128, 128, 256, 2), (128, 256, 256, 2), (128, 384, 128, 2),
                             (256, 512, 256, 1)]


def test_plans_fall_back_to_the_split_path():
    """Unaligned channels, more than 64 channels a group, or a slab past a
    cluster of 16 take the split path; its pieces cover a channel."""
    for cpg, hw, itemsize, arrays, aligned in ((4, 49, 2, 1, True), (8, 1024, 2, 1, False),
                                              (65, 64, 4, 1, True), (16, 65536, 4, 1, True),
                                              (8, 65536, 4, 2, True)):
        plan = gn.group_norm_plan(cpg, hw, itemsize, arrays, aligned)
        assert plan.path == "split" and plan.k == 0
        assert plan.pieces * plan.slice >= hw > (plan.pieces - 1) * plan.slice
        _assert_kernels_take(plan, cpg, hw, itemsize, arrays, aligned and hw % (16 // itemsize) == 0)
    assert gn.group_norm_plan(4, 65536, 2, 2).path == "split"  # 16 CTAs backward
    plan = gn.group_norm_plan(8, 65536, 2, 1)  # the same slab forward: a cluster of 16
    assert plan.path == "cluster" and plan.k == 16
    _assert_kernels_take(plan, 8, 65536, 2, 1)


def test_kernels_refuse_a_cpu_tensor():
    """The kernels' entry points raise on a CPU tensor: no fallback."""
    x, g, w, b, e = _inputs((2, 64, 4, 4), torch.float32, True, torch.Generator().manual_seed(1))
    with pytest.raises(ValueError):
        gn.forward_cuda(x, 32, w, b, 1e-5, e, True)
    mean = torch.zeros(2, 32)
    with pytest.raises(ValueError):
        gn.backward_cuda(x, g, 32, mean, mean, w, b, e, True)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(shape, dtype, emb, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.rand(c, generator=gen, device="cuda") + 0.5
    b = torch.randn(c, generator=gen, device="cuda")
    e = (torch.randn(shape[0], 2 * c, generator=gen, device="cuda") * 0.5).to(dtype) \
        if emb else None
    return x, g, w, b, e


def _assert_close(got, ref, dtype, what):
    """float32: the statistics summed in another order and SiLU's exp
    approximated (``__expf``), ~1e-6 relative, so 1e-5 relative and 1e-5 of
    the largest value; bf16: both round the same float32 value once, so at
    most one unit in the last place (relative spacing 2^-7) apart, and
    1e-3 of the largest value where the float32 values straddle a rounding
    boundary near 0."""
    ref = ref.float()
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-3)
    err = (got.float() - ref).abs() - rtol * ref.abs()
    assert torch.isfinite(got).all(), what
    assert float(err.max()) <= atol * float(ref.abs().max()) + 1e-6, (what, float(err.max()))


def _assert_sums_close(got, ref, mag, dtype, what):
    """A sum over N·H·W (dγ, dβ) or H·W (the scale-shift's gradient) float32
    terms in another order: within 1e-5 of the sum of the terms'
    magnitudes, plus the bf16 rounding of the scale-shift's gradient."""
    tol = 1e-5 * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all()), what


def _magnitudes(x, g, groups, w, b, e, silu):
    """Σ|du| and Σ|du·x̂| over each channel's values, (N, C) float32: the
    scale of the sums behind P and Q."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + 1e-5)
    xh = ((xf - mean) * rstd).reshape(n, c, -1)
    du = g.float().reshape(n, c, -1).abs()
    if silu:
        sc = 1 + e.float()[:, :c, None] if e is not None else 1.0
        sh = e.float()[:, c:, None] if e is not None else 0.0
        u = (xh * w[:, None] + b[:, None]) * sc + sh
        sg = torch.sigmoid(u)
        du = du * (sg * (1 + u * (1 - sg))).abs()
    return du.sum(-1), (du * xh.abs()).sum(-1)


def _check_site(x, g, groups, w, b, e, silu):
    """Forward and backward on their planned paths against the twin;
    returns the kernels' outputs."""
    dtype = x.dtype
    y, mean, rstd = gn.forward_cuda(x, groups, w, b, 1e-5, e, silu)
    _assert_close(y, gn.group_norm_act_plain(x, groups, w, b, 1e-5, e, silu), dtype, "forward")
    n = x.shape[0]
    xf = x.float().reshape(n, groups, -1)
    ref_mean = xf.mean(-1)
    ref_rstd = torch.rsqrt((xf - ref_mean[..., None]).square().mean(-1) + 1e-5)
    assert torch.allclose(mean, ref_mean, rtol=1e-5, atol=1e-5)
    assert torch.allclose(rstd, ref_rstd, rtol=1e-5, atol=1e-5)
    dx, dw, db, de = gn.backward_cuda(x, g, groups, mean, rstd, w, b, e, silu)
    rdx, rdw, rdb, rde = gn.group_norm_act_backward_plain(x, g, groups, w, b, 1e-5, e, silu)
    _assert_close(dx, rdx, dtype, "dx")
    mp, mq = _magnitudes(x, g, groups, w, b, e, silu)
    sc = 1 + e.float()[:, :x.shape[1]].abs() if e is not None else torch.ones_like(mp)
    _assert_sums_close(dw, rdw, (sc * mq).sum(0), dtype, "dweight")
    _assert_sums_close(db, rdb, (sc * mp).sum(0), dtype, "dbias")
    if e is not None:
        mag = torch.cat([w.abs() * mq + b.abs() * mp, mp], 1)
        _assert_sums_close(de, rde, mag, dtype, "demb")
    return y, dx, dw, db, de


def _adm_sites():
    """Each distinct (C, side, scale-shift, SiLU) of the ADM cell's nets at
    256 px, with the directions it runs: the teacher forward, the student
    forward and backward."""
    out = {}
    for mc, backward in ((256, False), (128, True)):
        for name, c, side in group_norm_sites(ADMConfig(model_channels=mc)):
            emb = name.endswith("out_layers.0")
            silu = not name.endswith(".norm")
            key = (c, side, emb, silu)
            out[key] = out.get(key, False) or backward
    return sorted(out.items())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("site", _adm_sites(),
                         ids=lambda s: "C{}_s{}_ss{:d}_silu{:d}".format(*s[0]))
def test_kernels_match_the_twin_at_every_adm_site(cuda, dtype, site):
    """Forward and backward at every site shape of the cell (batch 16,
    256 px), bf16 and float32, on the path each plan picks."""
    (c, side, emb, silu), _ = site
    x, g, w, b, e = _card_inputs((16, c, side, side), dtype, emb, c + side)
    _check_site(x, g, 32, w, b, e, silu)


def _misaligned(t):
    """A contiguous copy of t one element past a 16-byte boundary: the
    plan's unaligned input (no 16-byte accesses)."""
    flat = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("emb,silu", VARIANTS)
@pytest.mark.parametrize("shape,groups", [((4, 64, 7, 9), 32), ((2, 96, 33, 33), 4),
                                          ((2, 130, 8, 8), 2), ((1, 256, 256, 256), 32)])
def test_split_path_and_big_clusters_match_the_twin(cuda, dtype, emb, silu, shape, groups):
    """The paths the shapes select: the split path where H·W takes no
    16-byte accesses (63, 1089), where a group has 65 channels (in 16-byte
    accesses), where the slab is past a cluster (1 MiB backward, 2 MiB
    float32 forward), and a cluster of 16 (the 1 MiB bf16 forward slab); then
    each shape again from an address one element past a 16-byte boundary,
    which takes the split path without 16-byte accesses."""
    x, g, w, b, e = _card_inputs(shape, dtype, emb, 11)
    cpg, hw, itemsize = shape[1] // groups, x[0, 0].numel(), x.element_size()
    expect = {(4, 64, 7, 9): "split", (2, 96, 33, 33): "split", (2, 130, 8, 8): "split",
              (1, 256, 256, 256): "cluster" if dtype == torch.bfloat16 else "split"}[shape]
    plan = gn.group_norm_plan(cpg, hw, itemsize, 1)
    assert plan.path == expect and (expect == "split" or plan.k == 16)
    before = dict(gn.path_launches)
    _check_site(x, g, groups, w, b, e, silu)
    assert gn.path_launches[expect] == before[expect] + 1
    before = gn.path_launches["split"]
    _check_site(_misaligned(x), _misaligned(g), groups, w, b, e, silu)
    assert gn.path_launches["split"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 512, 256, 256), (16, 128, 64, 64), (16, 2048, 8, 8)])
def test_kernels_are_bit_reproducible(cuda, dtype, shape):
    """Two calls give the same bits: no atomics, sums in a fixed order."""
    x, g, w, b, e = _card_inputs(shape, dtype, True, 4)
    runs = []
    for _ in range(2):
        y, mean, rstd = gn.forward_cuda(x, 32, w, b, 1e-5, e, True)
        runs.append((y, mean, rstd, *gn.backward_cuda(x, g, 32, mean, rstd, w, b, e, True)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _tiny_distiller(dtype):
    from benchmark.families import adm_ka
    from benchmark.families.common import seeded_weights
    from benchmark.reference import adm_ka as ref
    from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams
    from cat_tpu_torch.models.adm import ADMUNet
    import json

    config = json.load(open(os.path.join(REPO, "benchmark", "configs", "adm256_palette.json")))
    tiny, traffic = adm_ka.tiny(config)
    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + 5)
    nets = []
    for width in (tiny["teacher_model_channels"], tiny["student_model_channels"]):
        spec = adm_ka.net(tiny, width)
        shapes = ref.shapes(spec)
        net = ADMUNet(ADMConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in spec.items()})).cuda()
        net.load_state_dict(seeded_weights(shapes, gen, "cuda", False, ref.stds(shapes)))
        nets.append(net)
    hp = GenericDistillHParams(mapping_layers=tuple(tiny["taps"]), compute_dtype=dtype,
                               recon_loss_type="l2")
    dist = GenericDistiller(nets[0], nets[1], nets[0].cfg.tap_widths(), nets[1].cfg.tap_widths(),
                            hp, device="cuda")
    batch = adm_ka.bank(tiny, {**traffic, "bank": 1}, 2, gen, "cuda")[0]
    return dist, nets, batch


@pytest.mark.cuda
def test_bf16_distill_step_runs_every_site_through_the_kernels(cuda):
    """A tiny bf16 ADM distill step launches the forward once a GroupNorm
    site in both nets and the backward once a student site, and never
    calls ``F.group_norm`` on a CUDA tensor."""
    dist, (teacher, student), batch = _tiny_distiller("bfloat16")
    state, tparams = dist.init_state(0)
    cuda_calls = []
    orig = F.group_norm

    def spy(x, *args, **kw):
        if x.is_cuda:
            cuda_calls.append(tuple(x.shape))
        return orig(x, *args, **kw)

    f0, b0 = gn.launches, gn.bwd_launches
    F.group_norm = spy
    try:
        state, metrics = dist.train_step(state, tparams, batch, 1e-4)
        torch.cuda.synchronize()
    finally:
        F.group_norm = orig
    sites = len(group_norm_sites(teacher.cfg)), len(group_norm_sites(student.cfg))
    assert cuda_calls == []
    assert gn.launches - f0 == sum(sites)
    assert gn.bwd_launches - b0 == sites[1]
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())


@pytest.mark.cuda
def test_profiled_kernel_names_are_read_by_the_benchmark(cuda):
    """Under ``torch.profiler`` the kernels' trace names land in the
    ``other`` group and ``group_norm_ms_per_step`` reads them."""
    from torch.profiler import ProfilerActivity, profile

    import_stdlib_profile()  # the profiler loads TorchDynamo, which imports ``profile``
    x, g, w, b, e = _card_inputs((4, 256, 64, 64), torch.bfloat16, True, 9)
    leaves = [t.requires_grad_(True) for t in (x, w, b, e)]
    gn.group_norm_act(*leaves[:1], 32, *leaves[1:3], 1e-5, leaves[3], True).backward(g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = gn.group_norm_act(leaves[0], 32, leaves[1], leaves[2], 1e-5, leaves[3], True)
        out.backward(g)
        torch.cuda.synchronize()
    names = {ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA}
    ours = {n for n in names if "group_norm" in n}
    assert len(ours) >= 3, names  # forward, backward, channel sums
    for n in ours:
        assert group_of(n) == OTHER, n
        assert any(k in n.lower() for k in group_norm_ms_per_step.NAMES)
