"""The fused instance norm's backward and plan against the JAX package.

On the CPU ``fused_instance_norm_act`` runs the plain forward and the
closed-form plain twin of the backward kernel
(``instance_norm_act_backward_plain``); both are held against
``cat_tpu.ops.pallas_norm.fused_instance_norm_act``, whose backward is
``jax.vjp`` of ``instance_norm_act_xla``.  Inputs come from numpy with a
seed; the port is NCHW, the JAX package NHWC.  ``norm_plan`` is the pure
function that picks the CUDA kernel's path by shape (tests/test_torch_cuda.py
holds each path against the plain versions on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.ops import pallas_norm as jpn
from cat_tpu_torch.ops import instance_norm as tin
from cat_tpu_torch.ops import norm_sweep
from cat_tpu_torch.ops.instance_norm import NormPlan

torch.set_num_threads(1)

ACTS = ["relu", "leaky_relu", "none"]
SHAPES = [(2, 8, 16, 16), (1, 3, 32, 32), (3, 5, 7, 9)]  # NCHW; the last one ragged


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t.detach().float().numpy()).transpose(0, 2, 3, 1)


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    n, c, h, w = shape
    x = (rs.randn(n, h, w, c) * 2 + 0.5).astype(np.float32)  # NHWC
    g = rs.randn(n, h, w, c).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    return x, g, scale, bias


def _jax_vjp(x, g, scale, bias, act):
    _, vjp = jax.vjp(lambda a, s, b: jpn.fused_instance_norm_act(a, s, b, 1e-5, act),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _close(got, ref):
    # float32 sums in another order: rtol 1e-5 and 1e-5 of the largest entry
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# relu's gradient at a tie
# ---------------------------------------------------------------------------

# one plane [[-1, 1], [0, 0]]: the zeros equal the mean, so with scale 1 and
# bias 0 the pre-activation is exactly 0 there; upstream weights [1, 2, 3, 5]
TIE_X = np.array([-1.0, 1.0, 0.0, 0.0], np.float32).reshape(1, 2, 2, 1)  # NHWC
TIE_G = np.array([1.0, 2.0, 3.0, 5.0], np.float32).reshape(1, 2, 2, 1)


def _port_tie_grads(how):
    x, g = nchw(TIE_X), nchw(TIE_G)
    scale, bias = torch.ones(1), torch.zeros(1)
    if how == "twin":
        return tin.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, "relu")
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, scale, bias))
    fn = tin.fused_instance_norm_act if how == "fused" else tin.instance_norm_act_plain
    return torch.autograd.grad(fn(xs, ss, bs, 1e-5, "relu"), (xs, ss, bs), g)


@pytest.mark.parametrize("how", ["fused", "twin", "plain_autograd"])
def test_relu_gradient_at_a_tie_matches_jax(how):
    """jnp.maximum's gradient is ½ at a tie: JAX's dbias is 6 here (1·0 +
    2·1 + 3·½ + 5·½), where a gradient of 1 at the tie would give 10."""
    jdx, jds, jdb = _jax_vjp(TIE_X, TIE_G, np.ones(1, np.float32), np.zeros(1, np.float32),
                             "relu")
    assert float(jdb[0]) == pytest.approx(6.0, abs=1e-6)
    dx, ds, db = _port_tie_grads(how)
    assert float(db[0]) == pytest.approx(6.0, abs=1e-6)
    np.testing.assert_allclose(nhwc(dx), jdx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), jds, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the backward's plain twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_backward_twin_matches_jax_vjp(act, shape):
    x, g, scale, bias = _inputs(shape, seed=sum(shape) + len(act))
    jdx, jds, jdb = _jax_vjp(x, g, scale, bias, act)
    dx, ds, db = tin.instance_norm_act_backward_plain(
        nchw(x), nchw(g), torch.from_numpy(scale), torch.from_numpy(bias), 1e-5, act)
    _close(nhwc(dx), jdx)
    _close(ds.numpy(), jds)
    _close(db.numpy(), jdb)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_backward_twin_matches_autograd_of_plain(act, shape):
    """On data without ties (every pre-activation nonzero), the closed form
    equals autograd of ``instance_norm_act_plain``."""
    x, g, scale, bias = _inputs(shape, seed=7 * sum(shape) + len(act))
    xt, gt = nchw(x), nchw(g)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    xf = xt.double()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    z = (xf - mean) / (xf.var(dim=(2, 3), unbiased=False, keepdim=True) + 1e-5).sqrt() \
        * st.double()[:, None, None] + bt.double()[:, None, None]
    assert float(z.abs().min()) > 1e-4
    xs, ss, bs = (t.clone().requires_grad_(True) for t in (xt, st, bt))
    ref = torch.autograd.grad(tin.instance_norm_act_plain(xs, ss, bs, 1e-5, act), (xs, ss, bs),
                              gt)
    got = tin.instance_norm_act_backward_plain(xt, gt, st, bt, 1e-5, act)
    for a, b in zip(got, ref):
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("act", ACTS)
def test_fused_op_on_the_cpu_takes_the_twin(act):
    """``fused_instance_norm_act``'s backward on a CPU tensor is the twin's
    closed form, launches nothing, and matches JAX's ``jax.vjp``."""
    x, g, scale, bias = _inputs((2, 4, 8, 8), seed=3)
    xs = nchw(x).requires_grad_(True)
    ss, bs = torch.from_numpy(scale).requires_grad_(True), torch.from_numpy(bias).requires_grad_(True)
    before = (tin.launches, tin.bwd_launches)
    got = torch.autograd.grad(tin.fused_instance_norm_act(xs, ss, bs, 1e-5, act), (xs, ss, bs),
                              nchw(g))
    assert (tin.launches, tin.bwd_launches) == before
    twin = tin.instance_norm_act_backward_plain(nchw(x), nchw(g), ss.detach(), bs.detach(),
                                                1e-5, act)
    for a, b in zip(got, twin):
        assert torch.equal(a, b)
    jdx, jds, jdb = _jax_vjp(x, g, scale, bias, act)
    _close(nhwc(got[0]), jdx)
    _close(got[1].numpy(), jds)
    _close(got[2].numpy(), jdb)


@pytest.mark.parametrize("act", ACTS)
def test_backward_twin_takes_the_forward_statistics(act):
    """Given the statistics it would compute itself, the twin gives the same
    bits; given other ones, xhat (and so dx) follows them."""
    x, g, scale, bias = _inputs((2, 3, 8, 8), seed=11)
    x, g, scale, bias = nchw(x), nchw(g), torch.from_numpy(scale), torch.from_numpy(bias)
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    rstd = torch.rsqrt(xf.square().mean(dim=(2, 3)) - mean.square() + 1e-5)
    own = tin.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act)
    given = tin.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act,
                                                 (mean.reshape(-1), rstd.reshape(-1)))
    for a, b in zip(own, given):
        assert torch.equal(a, b)
    other = tin.instance_norm_act_backward_plain(x, g, scale, bias, 1e-5, act,
                                                 (mean.reshape(-1), 2 * rstd.reshape(-1)))
    assert not torch.allclose(other[0], own[0])


def test_backward_kernel_refuses_cpu_tensors():
    x = torch.ones(1, 2, 4, 4)
    stats = torch.zeros(2), torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        tin.instance_norm_act_backward_cuda(x, x, *stats, torch.ones(2), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        tin.forward_cuda(x, torch.ones(2), torch.zeros(2))


# ---------------------------------------------------------------------------
# the kernel's plan by shape
# ---------------------------------------------------------------------------

PLANS = [
    # (H·W, bytes a value, arrays, aligned) -> plan.  The flagship's planes
    # (256², 128², 64²) in both dtypes, forward (x) and backward (x and g)
    ((256 * 256, 2, 1, True), NormPlan("one_cta", 1, 1, 65536, 16384)),
    ((256 * 256, 4, 1, True), NormPlan("cluster", 4, 1, 16384, 4096)),
    ((128 * 128, 2, 1, True), NormPlan("one_cta", 1, 1, 16384, 4096)),
    ((128 * 128, 4, 1, True), NormPlan("one_cta", 1, 1, 16384, 4096)),
    ((64 * 64, 2, 1, True), NormPlan("one_cta", 1, 4, 4096, 4096)),
    ((64 * 64, 4, 1, True), NormPlan("one_cta", 1, 2, 4096, 4096)),
    ((256 * 256, 2, 2, True), NormPlan("cluster", 4, 1, 16384, 4096)),
    ((256 * 256, 4, 2, True), NormPlan("cluster", 8, 1, 8192, 2048)),
    ((128 * 128, 2, 2, True), NormPlan("one_cta", 1, 1, 16384, 4096)),
    ((128 * 128, 4, 2, True), NormPlan("one_cta", 1, 1, 16384, 4096)),
    ((64 * 64, 2, 2, True), NormPlan("one_cta", 1, 2, 4096, 4096)),
    ((64 * 64, 4, 2, True), NormPlan("one_cta", 1, 1, 4096, 1024)),
    # GauGAN's 512 x 256
    ((512 * 256, 2, 1, True), NormPlan("cluster", 4, 1, 32768, 8192)),
    ((512 * 256, 4, 1, True), NormPlan("cluster", 8, 1, 16384, 4096)),
    ((512 * 256, 4, 2, True), tin.TWO_PASS),
    # past 8 slices of 64 KiB
    ((512 * 512, 4, 1, True), tin.TWO_PASS),
    ((1024 * 1024, 2, 1, True), tin.TWO_PASS),
    # H·W·sizeof not a multiple of 16 bytes, or an unaligned pointer
    ((7 * 9, 4, 1, True), tin.TWO_PASS),
    ((255 * 255, 2, 1, True), tin.TWO_PASS),
    ((128 * 128, 2, 1, False), tin.TWO_PASS),
    # tiny planes pack up to 8 a CTA; a slice past 8 KiB is cut in chunks
    ((4 * 4, 4, 1, True), NormPlan("one_cta", 1, 8, 16, 16)),
    ((96 * 96, 2, 1, True), NormPlan("one_cta", 1, 1, 9216, 4608)),
    ((512 * 64, 4, 1, True), NormPlan("one_cta", 1, 1, 32768, 8192)),  # 128 KiB whole
    ((512 * 64 + 4, 4, 1, True), NormPlan("cluster", 3, 1, 10924, 2732)),  # past it
    ((200 * 200, 4, 1, True), NormPlan("cluster", 3, 1, 13336, 3336)),
]


@pytest.mark.parametrize("args, plan", PLANS, ids=[str(a) for a, _ in PLANS])
def test_norm_plan(args, plan):
    assert tin.norm_plan(*args) == plan


@pytest.mark.parametrize("hw, itemsize, arrays",
                         [(h * w, s, a) for h, w in ((256, 256), (128, 128), (64, 64),
                                                     (512, 256), (200, 200), (4, 4), (96, 96),
                                                     (512, 64), (300, 300))
                          for s in (2, 4) for a in (1, 2)])
def test_norm_plan_covers_each_plane_in_aligned_pieces(hw, itemsize, arrays):
    """Every on-chip plan stages at most 128 KiB a CTA (64 KiB a cluster's
    CTA), covers each plane with
    its k slices (none empty) and each slice with at most 4 chunks of whole
    16-byte accesses, and packs planes only into whole warps."""
    p = tin.norm_plan(hw, itemsize, arrays)
    if p.path == "two_pass":
        assert hw * itemsize * arrays > 8 * (64 << 10)
        return
    vec = 16 // itemsize
    most = (128 << 10) if p.k == 1 else (64 << 10) + 16 * arrays
    assert p.ppc * p.slice * itemsize * arrays <= most
    assert p.slice % vec == 0 and p.chunk % vec == 0 and 256 % (32 * p.ppc) == 0
    assert (p.k - 1) * p.slice < hw <= p.k * p.slice
    assert (p.k > 1) == (p.path == "cluster") and 1 <= p.k <= 8
    assert p.ppc == 1 or p.chunk == p.slice == hw
    assert -(-p.slice // p.chunk) <= 4


@pytest.mark.parametrize("hw", [256 * 256, 128 * 128, 64 * 64])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("arrays", [1, 2])
def test_norm_plan_is_among_the_swept_variants(hw, itemsize, arrays):
    """``norm_sweep`` times every plan a CTA can hold at the flagship's
    planes; the one ``norm_plan`` picks is among them, and the kernel's
    plan check takes each."""
    variants = norm_sweep.variants(hw, itemsize, arrays)
    assert tin.norm_plan(hw, itemsize, arrays) in variants
    for p in variants:
        tin._check_plan(p, hw, itemsize, arrays, vec=1)


@pytest.mark.parametrize("plan", [
    NormPlan("cluster", 9, 1, 512, 512),  # past the portable cluster size
    NormPlan("cluster", 2, 1, 1024, 1024),  # two slices do not cover the plane
    NormPlan("one_cta", 1, 1, 4096, 256),  # 16 chunks: more mbarriers than a CTA has
    NormPlan("one_cta", 1, 3, 4096, 4096),  # 3 planes do not split 256 threads in warps
    NormPlan("cluster", 2, 2, 2048, 2048),  # packed planes over a cluster
    NormPlan("one_cta", 1, 1, 4090, 4090),  # not whole 16-byte accesses
])
def test_the_kernel_refuses_a_plan_it_cannot_take(plan):
    with pytest.raises(ValueError, match="cannot take"):
        tin._check_plan(plan, 4096, 4, 1, vec=1)
    tin._check_plan(tin.TWO_PASS, 4096, 4, 1, vec=0)  # the loop takes any plane
