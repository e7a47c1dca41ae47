"""The port's primitives, blocks, generator, discriminator and losses
against the JAX package on the same weights and inputs (CPU, float32).

JAX weights come from ``conftest.fast_init`` (numpy-filled, no XLA init)
and reach the port through ``cat_tpu_torch.utils.jax_import``.  The port is
NCHW, the JAX package NHWC.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.core import config as jcfg
from cat_tpu.models import losses as jlosses
from cat_tpu.models.blocks import InceptionBlock as JBlock
from cat_tpu.models.discriminators import NLayerDiscriminator as JD
from cat_tpu.models.generator import InceptionGenerator as JGen
from cat_tpu.ops import nn as jnn
from cat_tpu.utils.torch_import import import_inception_generator, recover_generator_config
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.models import losses as tlosses
from cat_tpu_torch.models.blocks import InceptionBlock as TBlock
from cat_tpu_torch.models.discriminators import NLayerDiscriminator as TD
from cat_tpu_torch.models.generator import InceptionGenerator as TGen
from cat_tpu_torch.ops import nn as tnn
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_gen_fixture.npz")
TAPS = ("encode", "block0", "block1")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def to_port(cfg):
    """A JAX config as the port's, through JSON."""
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def tiny_cfg(**kw):
    # ngf 8, 2 blocks, kernels up to 5: the bottleneck of a 32 px input is
    # 8 px, the smallest map reflect padding of 2 accepts
    kw = {"ngf": 8, "channels_reduction_factor": 2, "kernel_sizes": (1, 3, 5),
          "n_blocks": 2, **kw}
    return jcfg.InceptionGeneratorConfig.make(**kw)


def dead_branch_cfg():
    base = tiny_cfg()
    block = jcfg.InceptionBlockConfig(dim=32, res_channels=(3, 0, 6), dw_channels=(0, 5, 4),
                                      res_kernels=(1, 3, 5), dw_kernels=(1, 3, 5))
    empty = jcfg.InceptionBlockConfig(dim=32, res_channels=(0, 0), dw_channels=(0, 0),
                                      res_kernels=(1, 3), dw_kernels=(1, 3))
    return dataclasses.replace(base, blocks=(block, empty))


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affine", [True, False])
def test_norm2d_matches_jax(rng, affine):
    norm = jcfg.NormConfig(kind="instance", affine=affine)
    x = (rng.randn(2, 5, 7, 6) * 3 + 2).astype(np.float32)
    variables = {}
    m = tnn.Norm2d(to_port(norm), 6)
    if affine:
        scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
        variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
        m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    ref = jnn.Norm2d(norm).apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(nhwc(m(nchw(x))), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_conv_transpose_matches_jax(rng):
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    params = {"kernel": rng.randn(3, 3, 4, 7).astype(np.float32),
              "bias": rng.randn(7).astype(np.float32)}
    ref = jnn.ConvTranspose2d(features=7).apply({"params": params}, jnp.asarray(x))
    sd = {}
    jax_import._convt(sd, "m", params)
    m = tnn.ConvTranspose2d(4, 7)
    m.load_state_dict({"weight": sd["m.weight"], "bias": sd["m.bias"]})
    y = m(nchw(x))
    assert y.shape == (2, 7, 10, 12)
    np.testing.assert_allclose(nhwc(y), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "zero"])
def test_spatial_pad_matches_jax(rng, mode):
    x = rng.randn(1, 4, 5, 2).astype(np.float32)
    ref = jnn.spatial_pad(jnp.asarray(x), 2, mode)
    np.testing.assert_array_equal(nhwc(tnn.spatial_pad(nchw(x), 2, mode)), np.asarray(ref))


# ---------------------------------------------------------------------------
# Inception block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dead", [False, True])
def test_inception_block_matches_jax(rng, packed, dead):
    cfg = dead_branch_cfg() if dead else tiny_cfg()
    bcfg, norm = cfg.blocks[0], cfg.norm
    x = rng.randn(2, 8, 8, bcfg.dim).astype(np.float32)
    jblock = JBlock(bcfg, norm=norm)
    variables = fast_init(jblock, jnp.zeros((1, 8, 8, bcfg.dim)), seed=3)
    ref = jblock.apply(variables, jnp.asarray(x))
    tblock = TBlock(to_port(bcfg), norm=to_port(norm), packed=packed)
    tblock.load_state_dict(jax_import.inception_block_state_dict(variables["params"], bcfg))
    np.testing.assert_allclose(nhwc(tblock(nchw(x))), np.asarray(ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_generator():
    cfg = tiny_cfg()
    variables = fast_init(JGen(cfg), jnp.zeros((1, 32, 32, 3)), seed=5)
    x = np.random.RandomState(11).randn(2, 32, 32, 3).astype(np.float32)
    y, acts = JGen(cfg).apply(variables, jnp.asarray(x), taps=TAPS)
    return cfg, variables, x, np.asarray(y), {k: np.asarray(v) for k, v in acts.items()}


@pytest.mark.parametrize("packed,fused", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_generator_with_taps_matches_jax(jax_generator, packed, fused):
    cfg, variables, x, y_ref, acts_ref = jax_generator
    gen = TGen(to_port(cfg), packed_blocks=packed, fused_norms=fused)
    gen.load_state_dict(jax_import.generator_state_dict(variables["params"], cfg))
    y, acts = gen(nchw(x), taps=TAPS)
    np.testing.assert_allclose(nhwc(y), y_ref, atol=1e-4)
    assert set(acts) == set(TAPS)
    for k in TAPS:
        np.testing.assert_allclose(nhwc(acts[k]), acts_ref[k], rtol=1e-4, atol=1e-4)


def test_generator_weights_go_back_to_jax_unchanged(jax_generator):
    """The port's state_dict keys are the reference CAT's: the JAX
    package's own importer turns them back into the original tree."""
    cfg, variables, *_ = jax_generator
    gen = TGen(to_port(cfg))
    gen.load_state_dict(jax_import.generator_state_dict(variables["params"], cfg))
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    _, back = import_inception_generator(sd, cfg)
    flat_a = {k: np.asarray(v) for k, v in _flatten(variables["params"]).items()}
    flat_b = _flatten(back["params"])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_generator_with_dead_branches_and_empty_block(rng):
    cfg = dead_branch_cfg()
    variables = fast_init(JGen(cfg), jnp.zeros((1, 32, 32, 3)), seed=2)
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    ref = JGen(cfg).apply(variables, jnp.asarray(x))
    gen = TGen(to_port(cfg), packed_blocks=True)
    assert not any(k.startswith("features.1.") for k in gen.state_dict())
    gen.load_state_dict(jax_import.generator_state_dict(variables["params"], cfg))
    np.testing.assert_allclose(nhwc(gen(nchw(x))), np.asarray(ref), atol=1e-4)


def test_generator_matches_reference_fixture():
    """The reference CAT's own state_dict loads as is and reproduces the
    output captured from the reference model."""
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    cfg = to_port(recover_generator_config({k: v.numpy() for k, v in sd.items()}))
    gen = TGen(cfg)
    gen.load_state_dict(sd)
    out = gen(torch.from_numpy(data["x"]))
    np.testing.assert_allclose(out.detach().numpy(), data["ref"].transpose(0, 3, 1, 2),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# Discriminator and losses
# ---------------------------------------------------------------------------


def test_nlayer_discriminator_matches_jax(rng):
    cfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8)
    variables = fast_init(JD(cfg), jnp.zeros((1, 32, 32, 3)), seed=4)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ref = JD(cfg).apply(variables, jnp.asarray(x))
    d = TD(to_port(cfg))
    d.load_state_dict(jax_import.nlayer_discriminator_state_dict(variables["params"], cfg))
    np.testing.assert_allclose(nhwc(d(nchw(x))), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "hinge", "wgangp"])
def test_gan_loss_matches_jax(rng, mode):
    pred = rng.randn(2, 1, 6, 6).astype(np.float32)
    pyramid = [[rng.randn(2, 1, 3, 3).astype(np.float32), pred], pred * 0.5]
    cases = [(True, True), (False, True), (True, False)]
    if mode != "hinge":
        cases.append((False, False))
    for real, for_d in cases:
        for p in (pred, pyramid):
            ref = jlosses.gan_loss(_tree(p, jnp.asarray), real, mode, for_d)
            got = tlosses.gan_loss(_tree(p, torch.from_numpy), real, mode, for_d)
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)


def _tree(p, fn):
    if isinstance(p, list):
        return [_tree(q, fn) for q in p]
    return fn(p)


@pytest.mark.parametrize("kind", ["l1", "l2", "smooth_l1"])
def test_recon_loss_matches_jax(rng, kind):
    a, b = (rng.randn(2, 3, 8, 8) * 2).astype(np.float32), rng.randn(2, 3, 8, 8).astype(np.float32)
    ref = jlosses.recon_loss(jnp.asarray(a), jnp.asarray(b), kind)
    got = tlosses.recon_loss(torch.from_numpy(a), torch.from_numpy(b), kind)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
