"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.ops import instance_norm as tin

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.RandomState(233)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300), (5, 4096), (32, 64 * 64 * 40), (128, 1000)])
def test_gram_kernel_matches_plain(cuda, rng, dtype, shape):
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dtype)
    before = tka.launches
    got = tka.gram(x)
    torch.cuda.synchronize()
    assert tka.launches == before + 1
    ref = tka.gram_plain(x)
    # f32 sums in another order: 1e-5 of the largest entry
    tol = 1e-5 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


def _bf16_operand(cuda, b, f, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(b, f, generator=gen, device=cuda).to(torch.bfloat16)


def _assert_gram_close(got, x):
    ref = tka.gram_plain(x)
    # f32 sums in another order: 1e-5 of the largest entry
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64 * 64 * 40, 64 * 64 * 256, 4096 * 3 + 8,  # ragged last tile
                               64 * 50])  # fewer tiles than SMs: some CTAs get none
@pytest.mark.parametrize("b", [1, 16, 33, 64, 100, 128])
def test_gram_tma_kernel_matches_plain(cuda, b, f):
    x = _bf16_operand(cuda, b, f, seed=b * 7 + f)
    before = tka.path_launches["tma"]
    got = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert tka.path_launches["tma"] == before + 1
    _assert_gram_close(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 128])
def test_gram_tma_kernel_is_bit_reproducible(cuda, b):
    x = _bf16_operand(cuda, b, 64 * 64 * 256, seed=b)
    first = tka.gram_cuda(x)
    second = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("b, f", [(128, 64 * 64 * 58), (100, 4096 * 3 + 4)])
def test_gram_mma_kernel_matches_plain(cuda, b, f):
    """The mma.sync kernel: the main path's for F % 8 != 0, and reached
    directly on a shape the TMA kernel takes (to compare the two designs)."""
    x = _bf16_operand(cuda, b, f, seed=3)
    before = tka.path_launches["mma"]
    got = tka._gram_launch(x, "mma")
    torch.cuda.synchronize()
    assert tka.path_launches["mma"] == before + 1
    _assert_gram_close(got, x)


def _f32_operand(cuda, b, f, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(b, f, generator=gen, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64 * 64 * 58, 64 * 64 * 256, 4096 * 3 + 4,  # ragged last tile
                               64 * 50])  # fewer tiles than SMs: some CTAs get none
@pytest.mark.parametrize("b", [1, 8, 33, 80, 100, 128])
def test_gram_f32_tma_kernel_matches_plain(cuda, b, f):
    x = _f32_operand(cuda, b, f, seed=b * 7 + f)
    before = tka.path_launches["f32tma"]
    got = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert tka.path_launches["f32tma"] == before + 1
    _assert_gram_close(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [80, 128])
def test_gram_f32_tma_kernel_is_bit_reproducible_and_symmetric(cuda, b):
    x = _f32_operand(cuda, b, 64 * 64 * 256, seed=b)
    first = tka.gram_cuda(x)
    second = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, first.T)


@pytest.mark.cuda
@pytest.mark.parametrize("b, f", [(80, 4096 * 3 + 2), (128, 64 * 64 * 58)])
def test_gram_f32_fma_kernel_matches_plain(cuda, b, f):
    """The FMA kernel: the main path's for float32 operands TMA cannot map
    (F % 4 != 0), and reached directly on a shape the TMA kernel takes (to
    compare the two designs)."""
    x = _f32_operand(cuda, b, f, seed=5)
    before = tka.path_launches["f32"]
    got = tka.gram_cuda(x) if f % 4 else tka._gram_launch(x, "f32")
    torch.cuda.synchronize()
    assert tka.path_launches["f32"] == before + 1
    _assert_gram_close(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, f", [(129, 64 * 64 * 40), (256, 64 * 64 * 58), (300, 4096 * 3 + 4)])
def test_gram_past_128_rows_goes_through_the_kernels(cuda, b, f, dtype):
    """B > 128: one launch of the pair kernel of the dtype (all pairs of
    128-row blocks), the plain versions' result within float32 rounding,
    exactly symmetric."""
    gen = torch.Generator(device=cuda).manual_seed(b)
    x = torch.randn(b, f, generator=gen, device=cuda).to(dtype)
    path = "f32tma_pairs" if dtype == torch.float32 else "tma_pairs"
    before, on_path = tka.launches, tka.path_launches[path]
    got = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert tka.launches == before + 1 and tka.path_launches[path] == on_path + 1
    assert torch.equal(got, got.T)
    _assert_gram_close(got, x)
    # the pair kernels' own plain version: the same blocks, the same mirroring
    ref = tka.gram_pairs_plain(x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [129, 256, 300])
def test_gram_pair_kernels_are_bit_reproducible_and_symmetric(cuda, b, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b + 1)
    x = torch.randn(b, 64 * 64 * 40, generator=gen, device=cuda).to(dtype)
    first = tka.gram_cuda(x)
    second = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, first.T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, f", [(torch.bfloat16, 4096 * 3 + 4), (torch.float32, 4096 * 3 + 2),
                                      (torch.bfloat16, 4096), (torch.float32, 4096)])
def test_gram_pair_kernels_take_a_padded_copy(cuda, dtype, f):
    """An operand TMA cannot map at B > 128 (a row of F·itemsize bytes not a
    multiple of 16, or a base not 16-byte aligned) is copied zero-padded
    and goes to the same pair kernel, once."""
    b = 200
    gen = torch.Generator(device=cuda).manual_seed(f)
    flat = torch.randn(b * f + 8, generator=gen, device=cuda).to(dtype)
    # F % 8 == 0: take X one element past an aligned base
    x = flat[:b * f].view(b, f) if f % 8 else flat[1:1 + b * f].view(b, f)
    assert tka._pair_copy_width(f, dtype, x.data_ptr() % 16 == 0) is not None
    path = "f32tma_pairs" if dtype == torch.float32 else "tma_pairs"
    before = tka.path_launches[path]
    got = tka.gram_cuda(x)
    torch.cuda.synchronize()
    assert tka.path_launches[path] == before + 1
    assert torch.equal(got, got.T)
    _assert_gram_close(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(2, 8, 64, 64), (2, 4, 128, 128), (1, 2, 256, 256),
                                   (3, 5, 7, 9)])
def test_instance_norm_kernel_matches_plain(cuda, rng, dtype, act, shape):
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)).to(cuda, dtype)
    c = shape[1]
    scale = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    before = tin.launches
    got = tin.instance_norm_act(x, scale, bias, act=act)
    torch.cuda.synchronize()
    assert tin.launches == before + 1
    ref = tin.instance_norm_act_plain(x, scale, bias, act=act)
    # f32: statistics summed in another order; bf16: one unit in the last
    # place of the output (relative spacing 2^-7)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
    err = (got.float() - ref.float()).abs() - rtol * ref.float().abs()
    assert float(err.max()) <= atol


def _norm_inputs(cuda, rng, shape, dtype):
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32)).to(cuda, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dtype)
    c = shape[1]
    scale = torch.from_numpy((rng.rand(c) + 0.5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
    return x, g, scale, bias


def _assert_norm_close(got, ref, dtype):
    # f32: statistics summed in another order; bf16: one unit in the last
    # place of the output (relative spacing 2^-7)
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
    err = (got.float() - ref.float()).abs() - rtol * ref.float().abs()
    assert torch.isfinite(got).all() and float(err.max()) <= atol


def _assert_channel_sums_close(x, g, scale, bias, act, ds, db, ref_ds, ref_db):
    """dscale and dbias sum N·H·W float32 terms per channel in another
    order: within 1e-5 of the sum of the terms' magnitudes."""
    xf, gf = x.double(), g.double()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    xh = (xf - mean) * torch.rsqrt(xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()
                                   + 1e-5)
    z = xh * scale.double()[:, None, None] + bias.double()[:, None, None]
    gp = gf * tin._act_grad(z, act).double()
    for got, ref, terms in ((ds, ref_ds, gp * xh), (db, ref_db, gp)):
        tol = 1e-5 * terms.abs().sum(dim=(0, 2, 3)).float() + 1e-6
        assert bool(((got - ref).abs() <= tol).all())


# (shape, dtype) -> path: one CTA with 2-4 packed planes, one CTA a plane,
# clusters of 2-8, and the two-pass loop (unaligned, or past 8 slices)
NORM_SHAPES = [(2, 8, 64, 64), (2, 4, 128, 128), (1, 2, 256, 256), (1, 3, 512, 256),
               (3, 5, 7, 9), (1, 2, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_instance_norm_paths_match_plain(cuda, rng, dtype, act, shape):
    """The forward on the path its plan picks (and the two-pass loop on any
    plane) against the plain version, with each plane's mean and rstd."""
    x, _, scale, bias = _norm_inputs(cuda, rng, shape, dtype)
    path = tin.norm_plan(shape[2] * shape[3], x.element_size()).path
    ref = tin.instance_norm_act_plain(x, scale, bias, act=act)
    xf = x.float()
    mean = xf.mean(dim=(2, 3)).reshape(-1)
    rstd = torch.rsqrt(xf.square().mean(dim=(2, 3)).reshape(-1) - mean.square() + 1e-5)
    for plan, counted in ((None, path), (tin.TWO_PASS, "two_pass")):
        before = tin.path_launches[counted]
        y, m, r = tin.forward_cuda(x, scale, bias, 1e-5, act, plan)
        torch.cuda.synchronize()
        assert tin.path_launches[counted] == before + 1
        _assert_norm_close(y, ref, dtype)
        torch.testing.assert_close(m, mean, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r, rstd, rtol=1e-4, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_instance_norm_backward_kernel_matches_twin(cuda, rng, dtype, act, shape):
    """The backward kernel on its plan's path (and the two-pass loop on any
    plane) against ``instance_norm_act_backward_plain`` on the forward
    kernel's statistics (relu's mask flips where z is within a rounding of
    0, so both take the same mean and rstd)."""
    x, g, scale, bias = _norm_inputs(cuda, rng, shape, dtype)
    _, mean, rstd = tin.forward_cuda(x, scale, bias, 1e-5, act)
    path = tin.norm_plan(shape[2] * shape[3], x.element_size(), 2).path
    rdx, rds, rdb = tin.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act,
                                                         (mean, rstd))
    for plan, counted in ((None, path), (tin.TWO_PASS, "two_pass")):
        before = tin.bwd_path_launches[counted]
        dx, ds, db = tin.instance_norm_act_backward_cuda(x, g, mean, rstd, scale, bias, act,
                                                         plan)
        torch.cuda.synchronize()
        assert tin.bwd_path_launches[counted] == before + 1
        _assert_norm_close(dx, rdx, dtype)
        _assert_channel_sums_close(x, g, scale, bias, act, ds, db, rds, rdb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 8, 64, 64), (2, 4, 256, 256), (2, 3, 7, 9)])
def test_instance_norm_kernels_are_bit_reproducible(cuda, rng, dtype, shape):
    x, g, scale, bias = _norm_inputs(cuda, rng, shape, dtype)
    first = tin.forward_cuda(x, scale, bias)
    second = tin.forward_cuda(x, scale, bias)
    b1 = tin.instance_norm_act_backward_cuda(x, g, *first[1:], scale, bias)
    b2 = tin.instance_norm_act_backward_cuda(x, g, *first[1:], scale, bias)
    torch.cuda.synchronize()
    for a, b in zip((*first, *b1), (*second, *b2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_instance_norm_act_runs_both_kernels(cuda, rng, dtype):
    """Autograd through the fused op: one forward and one backward launch,
    the twin's gradients."""
    x, g, scale, bias = _norm_inputs(cuda, rng, (4, 6, 128, 128), dtype)
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    before = tin.launches, tin.bwd_launches
    y = tin.fused_instance_norm_act(xs, ss, bs)
    dx, ds, db = torch.autograd.grad(y, (xs, ss, bs), g)
    torch.cuda.synchronize()
    assert (tin.launches, tin.bwd_launches) == (before[0] + 1, before[1] + 1)
    stats = tin.forward_cuda(x, scale, bias)[1:]  # bit-identical to the fused op's
    rdx, rds, rdb = tin.instance_norm_act_backward_plain(x, g, scale, bias, stats=stats)
    _assert_norm_close(dx, rdx, dtype)
    _assert_channel_sums_close(x, g, scale, bias, "relu", ds, db, rds, rdb)


def _rel_gap(got, ref, scale):
    got, ref, scale = (t.detach().float() for t in (got, ref, scale))
    return float((got - ref).norm() / scale.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_packed_block_norms_go_through_the_kernels(cuda):
    """A packed bf16 inception block under fused_norms against its plain
    path on the card, output and every parameter's gradient: its norms take
    the kernel forward and backward once per kernel-size group of the first
    convs, once for the depthwise stage and once for ``pw_bn``."""
    from cat_tpu_torch.core.config import InceptionBlockConfig
    from cat_tpu_torch.models.blocks import InceptionBlock, block_norm_sites
    from cat_tpu_torch.ops.nn import Norm2d

    cfg = InceptionBlockConfig(dim=64, res_channels=(16, 24, 8), dw_channels=(8, 16, 24),
                               res_kernels=(1, 3, 5), dw_kernels=(1, 3, 5))
    torch.manual_seed(3)
    plain = InceptionBlock(cfg, packed=True)
    with torch.no_grad():  # scales and shifts away from 1 and 0
        for m in plain.modules():
            if isinstance(m, Norm2d):
                m.weight.copy_(torch.rand_like(m.weight) + 0.5)
                m.bias.copy_(torch.randn_like(m.bias) * 0.5)
    fused = InceptionBlock(cfg, packed=True, fused_norms=True)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(4, 64, 64, 64, device=cuda).to(torch.bfloat16)
    g = torch.randn(4, 64, 64, 64, device=cuda).to(torch.bfloat16)
    sites = len(block_norm_sites(cfg, packed=True, act="relu"))
    assert sites == 5  # kernel sizes 1, 3, 5; the depthwise stage; pw_bn
    outs = []
    for net in (plain, fused):
        net.to(cuda, torch.bfloat16)
        before = tin.launches, tin.bwd_launches
        y = net(x)
        names, params = zip(*net.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(y, params, g)))
        torch.cuda.synchronize()
        outs.append((y, grads, (tin.launches - before[0], tin.bwd_launches - before[1])))
    (y0, g0, n0), (y1, g1, n1) = outs
    assert n0 == (0, 0) and n1 == (sites, sites), (n0, n1)
    # bf16: the kernel rounds each norm's output once, the plain chain too,
    # from float32 values summed in another order; a unit in the last place
    # here and there, carried through the block's convs
    gap = _rel_gap(y1, y0, y0)
    assert gap <= 1e-2, gap
    for k in g0:
        # a conv bias that feeds an instance norm has a gradient of zero up
        # to rounding: its weight's gradient sets the size of that rounding
        sibling = g0.get(k[:-len("bias")] + "weight", g0[k]) if k.endswith("bias") else g0[k]
        gap = _rel_gap(g1[k], g0[k], max(g0[k], sibling, key=lambda t: float(t.norm())))
        assert torch.isfinite(g1[k]).all() and gap <= 3e-2, (k, gap)


# ---------------------------------------------------------------------------
# The distill verb's data path on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_device_prefetch_copies_host_batches_in_order(cuda):
    """Pinned, non_blocking copies on a side stream: every batch arrives on
    the card, in order and intact; batches already there pass through."""
    from cat_tpu_torch.data.loader import device_prefetch

    host = [{"A": torch.full((4, 3, 8, 8), float(i)), "A_paths": [str(i)]} for i in range(5)]
    on_card = [{"A": torch.full((2,), float(i), device=cuda)} for i in range(3)]
    out = list(device_prefetch(iter(host), cuda)) + list(device_prefetch(iter(on_card), cuda))
    assert all(b["A"].is_cuda for b in out)
    assert [float(b["A"].flatten()[0]) for b in out] == [0, 1, 2, 3, 4, 0, 1, 2]
    assert all(torch.equal(b["A"].cpu(), h["A"]) for b, h in zip(out, host))
    assert out[5]["A"] is on_card[0]["A"]


@pytest.mark.cuda
def test_judge_features_on_the_card_match_the_cpu(cuda, rng):
    """The InceptionV3 judge's pool3 features on the card (float32, TF32 off
    inside the judge even when the process turns it on) against the CPU's,
    within 1e-4 of the largest feature."""
    from cat_tpu_torch.metrics.inception import InceptionV3FID, random_judge_state_dict

    judge = InceptionV3FID()
    judge.load_state_dict(random_judge_state_dict(3))
    x = torch.from_numpy(rng.uniform(0, 1, (4, 3, 256, 256)).astype(np.float32))
    ref = judge(x)[0]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = judge.to(cuda)(x.to(cuda))[0].cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_device_bank_samples_the_same_patches_on_the_card(cuda, rng):
    """The same draws cut the same patches from a bank on the card as from
    one on the host: the same pixels, and values within one float32 unit in
    the last place (the card divides by 255 as a multiply by its
    reciprocal)."""
    from cat_tpu_torch.data.device_data import draw, sample_side

    bank = torch.from_numpy(rng.randint(0, 256, (5, 20, 20, 3)).astype(np.uint8))
    draws = draw(torch.Generator(device=cuda).manual_seed(0), 16, bank.shape, 12, False)
    got = sample_side(bank.to(cuda), *draws, 12).cpu()
    ref = sample_side(bank, *(d.cpu() for d in draws), 12)

    def pixels(t):
        return ((t + 1.0) * 127.5).round().to(torch.uint8)

    assert torch.equal(pixels(got), pixels(ref))
    assert float((got - ref).abs().max()) <= 2 ** -23


# ---------------------------------------------------------------------------
# The int8 convolutions (ops/quant.py)
# ---------------------------------------------------------------------------

INT8_CONVS = {  # (n, cin, cout, h, w, k, stride, pad, dilation, groups)
    "dense": (2, 16, 24, 19, 21, 3, 1, 1, 1, 1),
    "strided": (2, 16, 24, 19, 21, 3, 2, 1, 1, 1),
    "stem": (3, 3, 13, 33, 31, 7, 1, 3, 1, 1),  # K = 147, N = 13: both padded to 8
    "dilated": (1, 8, 16, 17, 17, 3, 1, 2, 2, 1),
    "depthwise_k5": (2, 40, 40, 17, 19, 5, 1, 2, 1, 40),
    "grouped": (2, 16, 32, 15, 13, 3, 2, 1, 1, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(INT8_CONVS))
def test_int8_conv_accumulator_is_exact_on_the_card(cuda, rng, kind):
    """The card's int32 accumulator (im2col + torch._int_mm for groups 1,
    csrc/int8_conv.cu otherwise; one launch of the path counted) equals the
    float64 plain version bit for bit, chunked im2col included; the grouped
    kernel's fused dequantisation equals acc · scale cast to float32 and to
    bf16, bit for bit."""
    from cat_tpu_torch.ops import quant as tq

    n, cin, cout, h, w, k, s, p, d, g = INT8_CONVS[kind]
    xq = torch.from_numpy(rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (cout, cin // g, k, k)).astype(np.int8))
    want = tq.int8_conv_acc_plain(xq, wq, s, p, d, g)
    before = dict(tq.launches)
    got = tq.int8_conv_acc(xq.to(cuda), wq.to(cuda), s, p, d, g)
    torch.cuda.synchronize()
    path = "intmm" if g == 1 else "grouped"
    assert tq.launches[path] == before[path] + 1
    assert torch.equal(got.cpu(), want)
    if g == 1:
        rows = want.shape[2] * want.shape[3]
        chunked = tq.im2col_acc(xq.to(cuda), wq.to(cuda), s, p, d,
                                max_bytes=rows * 8 * -(-cin * k * k // 8))
        assert torch.equal(chunked.cpu(), want)
    else:
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, cout).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            fused = tq.conv_dequant(xq.to(cuda), wq.to(cuda), scale.to(cuda), dtype, s, p, d, g)
            ref = (want.float() * scale.view(1, -1, 1, 1)).to(dtype)
            assert torch.equal(fused.cpu(), ref), dtype


@pytest.mark.cuda
def test_int8_conv_raises_instead_of_falling_back(cuda):
    """A grouped conv the kernel cannot take, or an output dtype its store
    does not write, raises; nothing falls back to a float conv or to a
    plain dequantisation."""
    from cat_tpu_torch.ops import quant as tq

    x = torch.zeros(1, 4, 8, 8, dtype=torch.int8, device=cuda)
    w = torch.zeros(6, 2, 3, 3, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        tq.grouped_conv_cuda(x, w, None, torch.int32, groups=3)
    with pytest.raises(ValueError):
        tq.grouped_conv_cuda(x.float(), w, None, torch.int32, groups=2)
    with pytest.raises(ValueError):
        tq.conv_dequant(x, w, torch.ones(6, device=cuda), torch.float16, groups=2)
