"""The port's two kernel modules against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (tests/test_torch_cuda.py
holds the CUDA kernels against the plain versions on the card).  Inputs
come from numpy with a seed; the port is NCHW, the JAX package NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.distill.ka import gram_pair as jax_gram_pair
from cat_tpu.distill.ka import ka as jax_ka
from cat_tpu.ops import pallas_norm as jpn
from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.ops import instance_norm as tin

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t.detach().float().numpy()).transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Gram / KA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_pair_matches_pallas_interpret(rng, dtype):
    # batch not a multiple of 8, features not a multiple of the tile, and
    # operands of different widths (teacher vs student)
    x = rng.randn(5, 300).astype(np.float32)
    y = rng.randn(5, 170).astype(np.float32)
    jd = jnp.dtype(dtype)
    gx_j, gy_j = jax_gram_pair(jnp.asarray(x, jd), jnp.asarray(y, jd), interpret=True)
    td = getattr(torch, dtype)
    gx_t, gy_t = tka.gram_pair(torch.from_numpy(x).to(td), torch.from_numpy(y).to(td))
    assert gx_t.dtype == torch.float32
    # f32 sums in another order: rtol 1e-5
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), rtol=1e-5, atol=1e-4)


def test_ka_value_and_gradients_match_jax(rng):
    x = rng.randn(4, 6, 6, 3).astype(np.float32)  # NHWC
    y = rng.randn(4, 6, 6, 2).astype(np.float32)

    def jloss(a, b):
        return -jax_ka(a, b, use_pallas="no")

    val_j = jloss(jnp.asarray(x), jnp.asarray(y))
    gx_j, gy_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    xt, yt = nchw(x).requires_grad_(True), nchw(y).requires_grad_(True)
    val_t = -tka.ka(xt, yt)
    gx_t, gy_t = torch.autograd.grad(val_t, (xt, yt))
    # KA does not depend on the flatten order (NCHW vs NHWC)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-5)
    np.testing.assert_allclose(nhwc(gx_t), np.asarray(gx_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(nhwc(gy_t), np.asarray(gy_j), rtol=1e-4, atol=1e-6)


def test_ka_backward_skips_the_gradient_nobody_asks_for(rng):
    """With Y fixed (the teacher's tap), the backward gives the same dX as
    the JAX package and runs one (B x B)(B x F) product, not two."""
    from torch.utils._python_dispatch import TorchDispatchMode

    x = rng.randn(4, 6, 6, 3).astype(np.float32)  # NHWC, as in the test above
    y = rng.randn(4, 6, 6, 2).astype(np.float32)
    gx_j = jax.grad(lambda a: -jax_ka(a, jnp.asarray(y), use_pallas="no"))(jnp.asarray(x))

    class Ops(TorchDispatchMode):
        @classmethod
        def _should_skip_dynamo(cls):
            # else the hook is wrapped in a dynamo guard, and importing dynamo
            # from the repository root picks up the root's profile.py
            return False

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket)
            return func(*args, **(kwargs or {}))

    xt, yt = nchw(x).requires_grad_(True), nchw(y)
    loss = -tka.ka(xt, yt)
    with Ops() as ops:
        loss.backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx_j), rtol=1e-4, atol=1e-6)
    assert ops.seen.count(torch.ops.aten.mm) == 1


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("b, f, dtype, aligned, path", [
    (128, 64 * 64 * 256, _BF16, True, "tma"),   # the teacher's tap
    (128, 64 * 64 * 58, _BF16, True, "tma"),    # the student's tap
    (1, 8, _BF16, True, "tma"),                 # smallest B and F TMA takes
    (128, 4096 * 3 + 4, _BF16, True, "mma"),    # row stride not a multiple of 16 bytes
    (33, 4096, _BF16, False, "mma"),            # base address not 16-byte aligned
    (128, 4096, _F32, True, "f32tma"),
    (80, 64 * 64 * 256, _F32, True, "f32tma"),  # the recipe's teacher tap (batch 80)
    (80, 64 * 64 * 58, _F32, True, "f32tma"),   # and its student tap
    (80, 4096 * 3 + 2, _F32, True, "f32"),      # row stride not a multiple of 16 bytes
    (80, 4096, _F32, False, "f32"),             # base address not 16-byte aligned
    (129, 4096, _F32, True, "blocked"),         # B past 128: pairs of 64-row blocks
    (129, 4096, _BF16, True, "blocked"),
    (300, 4096 * 3 + 2, _F32, False, "blocked"),
    (0, 4096, _BF16, True, ValueError),
    (16, 4096, torch.float16, True, ValueError),
])
def test_gram_path_rules(b, f, dtype, aligned, path):
    if path is ValueError:
        with pytest.raises(ValueError):
            tka._gram_path(b, f, dtype, aligned)
    else:
        assert tka._gram_path(b, f, dtype, aligned) == path


@pytest.mark.parametrize("b, bp, groups, warps", [
    (1, 8, 32, 1),      # one block, one warp
    (33, 40, 32, 15),   # 15 blocks of 32 threads (128-column tiles)
    (80, 80, 8, 14),    # the recipe's batch: 55 blocks, not 128 rows' 136
    (100, 104, 4, 12),
    (128, 128, 2, 9),   # 136 blocks
])
def test_f32_tma_plan(b, bp, groups, warps):
    """Rows padded to a multiple of 8, and as many threads per block of the
    triangle as 15 consumer warps allow (gram.cu checks the same limit)."""
    got_bp, got_groups = tka._f32_tma_plan(b)
    blocks = (bp // 8) * (bp // 8 + 1) // 2
    assert (got_bp, got_groups) == (bp, groups)
    assert -(-blocks * groups // 32) == warps


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("b", [129, 200, 256, 300])
def test_gram_blocked_dispatch(rng, b, dtype):
    """B > 128: the Gram from one launch per pair of 64-row blocks, each on
    a contiguous operand of at most 128 rows; X·Xᵀ within float32 rounding
    (rtol 1e-5), exactly symmetric, n(n-1)/2 launches for n = ⌈B/64⌉."""
    x = torch.from_numpy(rng.randn(b, 96).astype(np.float32)).to(dtype)
    seen = []

    def launch(op):
        assert op.shape[0] <= 128 and op.is_contiguous() and op.dtype == dtype
        seen.append(op.shape[0])
        return tka.gram_plain(op)

    got = tka.gram_blocked(x, launch)
    n = -(-b // 64)
    assert len(seen) == n * (n - 1) // 2
    assert got.dtype == torch.float32 and torch.equal(got, got.T)
    xd = x.double()
    np.testing.assert_allclose(got.numpy(), (xd @ xd.T).numpy(), rtol=1e-5, atol=1e-4)
    assert torch.equal(tka.gram_blocked(x, launch), got)  # reproducible


def test_ka_past_128_rows_matches_pallas_interpret(rng):
    """KA at B = 130 through the blocked dispatch (the plain version per
    launch on the CPU) against the JAX package's Pallas Gram, which takes any
    B, in interpret mode."""
    x = rng.randn(130, 40).astype(np.float32)
    y = rng.randn(130, 24).astype(np.float32)
    gx_j, gy_j = jax_gram_pair(jnp.asarray(x), jnp.asarray(y), interpret=True)
    for got, ref in ((tka.gram_blocked(torch.from_numpy(x), tka.gram_plain), gx_j),
                     (tka.gram_blocked(torch.from_numpy(y), tka.gram_plain), gy_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    val_j = jax_ka(jnp.asarray(x), jnp.asarray(y), use_pallas="no")
    np.testing.assert_allclose(float(tka.ka(torch.from_numpy(x), torch.from_numpy(y))),
                               float(val_j), rtol=1e-5)


def test_ka_backward_matches_autograd_of_formula(rng):
    x = torch.from_numpy(rng.randn(4, 50).astype(np.float32)).requires_grad_(True)
    y = torch.from_numpy(rng.randn(4, 30).astype(np.float32)).requires_grad_(True)

    def formula(a, b):
        ga, gb = a @ a.T, b @ b.T
        return (ga * gb).sum() / torch.sqrt((ga ** 2).sum() * (gb ** 2).sum())

    g_custom = torch.autograd.grad(-tka.ka(x, y), (x, y))
    g_auto = torch.autograd.grad(-formula(x, y), (x, y))
    for a, b in zip(g_custom, g_auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    assert float(tka.ka(x, x).detach()) == pytest.approx(1.0, rel=1e-6)


def test_ka_rejects_mismatched_batch():
    with pytest.raises(ValueError, match="batch"):
        tka.ka(torch.ones(3, 4), torch.ones(2, 4))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CPU tensor takes the plain version only through the dispatching
    wrapper; the kernel launchers never fall back to it."""
    with pytest.raises(ValueError, match="CUDA"):
        tka.gram_cuda(torch.ones(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tin.instance_norm_act_cuda(torch.ones(1, 2, 4, 4), torch.ones(2), torch.zeros(2))


# ---------------------------------------------------------------------------
# Instance norm + affine + act
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_instance_norm_act_matches_pallas_interpret(rng, act):
    x = (rng.randn(3, 8, 8, 16) * 2 + 0.5).astype(np.float32)
    scale = (rng.rand(16) + 0.5).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    ref = jpn.instance_norm_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                act=act, interpret=True)
    got = tin.instance_norm_act(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                act=act)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_fused_instance_norm_act_gradients_match_jax(rng, act):
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    scale = (rng.rand(8) + 0.5).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)

    def jloss(a, s, b):
        return jnp.sum(jpn.fused_instance_norm_act(a, s, b, 1e-5, act) ** 2)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                            jnp.asarray(bias))
    xt = nchw(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    loss = torch.sum(tin.fused_instance_norm_act(xt, st, bt, 1e-5, act) ** 2)
    gx, gs, gb = torch.autograd.grad(loss, (xt, st, bt))
    np.testing.assert_allclose(nhwc(gx), np.asarray(gj[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gj[1]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gj[2]), rtol=1e-4, atol=1e-5)
