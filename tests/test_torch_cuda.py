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
