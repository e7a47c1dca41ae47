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
