"""SPADE compression in the port against the JAX package (CPU, seeded
inputs): analytic profiling, the gamma collection and the FLOPs-targeted
shrink, the magnitude weight transfer, and the reference ``.pth`` loader in
both directions."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.compress import spade as jcs
from cat_tpu.compress.shrink import PruneBounds as JBounds
from cat_tpu.compress.transfer import transfer_spade_generator_params as jtransfer
from cat_tpu.core import config as jcfg
from cat_tpu.core import spade_config as jsc
from cat_tpu.models import spade as jspade
from cat_tpu.utils import spade_import as jimport
from cat_tpu_torch.compress import spade as tcs
from cat_tpu_torch.compress.shrink import PruneBounds
from cat_tpu_torch.compress.transfer import transfer_spade_generator_params
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.models import spade as tspade
from cat_tpu_torch.utils import jax_import
from cat_tpu_torch.utils import spade_import as timport

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_spade_fixture.npz")


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def recipe_cfg(num_up="more", ngf=64):
    """The GauGAN Cityscapes recipes' generator: 35 labels + dontcare + edges,
    kernels 1, 3, 5, channels / 6, crop 512 at aspect 2."""
    return jsc.SPADEGeneratorConfig.make(semantic_nc=37, ngf=ngf, channels_reduction_factor=6,
                                         kernel_sizes=(1, 3, 5), num_upsampling_layers=num_up,
                                         crop_size=512, aspect_ratio=2.0)


def tiny_cfg(ngf=4, kernel_sizes=(1, 3)):
    return jsc.SPADEGeneratorConfig.make(semantic_nc=5, ngf=ngf, channels_reduction_factor=4,
                                         kernel_sizes=kernel_sizes, num_upsampling_layers="normal",
                                         crop_size=64, aspect_ratio=2.0, nhidden=16)


def with_pruned_branches(cfg):
    """``cfg`` with branch 0 of every block's res and of every nested SPADE's
    dw list pruned away (width 0): the positions of the branches that exist
    then differ from their config indices."""
    blocks = []
    for b in cfg.blocks:
        sp = dataclasses.replace(b.spade, dw_channels=(0,) + b.spade.dw_channels[1:])
        blocks.append(dataclasses.replace(b, res_channels=(0,) + b.res_channels[1:], spade=sp))
    return dataclasses.replace(cfg, blocks=tuple(blocks))


def seeded_generator(cfg, seed, tied=False):
    """The port's generator with seeded weights; every norm scale drawn from
    U(0.05, 2) (a few distinct values with ``tied``) and every running
    statistic moved."""
    rs = np.random.RandomState(seed)
    gen = tspade.SPADEGenerator(to_port(cfg), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in gen.state_dict().items():
            if name.endswith("norm.weight") or name.endswith("shortcut.0.weight"):
                v = (rs.choice([0.25, 0.5, 1.0, 1.5], p.shape) if tied
                     else rs.uniform(0.05, 2.0, p.shape))
            elif name.endswith("running_var"):
                v = rs.uniform(0.5, 1.5, p.shape)
            elif name.endswith("running_mean") or name.endswith("bias"):
                v = rs.randn(*p.shape) * 0.1
            else:
                continue
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return gen


def jax_variables(gen, cfg):
    """The JAX package's variables of the port's generator, through the JAX
    package's own importer (which names a branch by its config index)."""
    _, variables = jimport.import_spade_generator(
        {k: v.numpy() for k, v in gen.state_dict().items()}, cfg=cfg)
    return variables


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,size", [
    (recipe_cfg("more"), (256, 512)),
    (recipe_cfg("normal"), (256, 512)),
    (recipe_cfg("most", ngf=48), (256, 512)),
    (with_pruned_branches(recipe_cfg("more")), (256, 512)),
    (tiny_cfg(), (32, 64)),
    (tiny_cfg(kernel_sizes=(3,)), (64, 128)),
])
def test_profile_spade_generator_equals_jax(cfg, size):
    """MACs, parameters and each section's MACs, as integers."""
    want = jcs.profile_spade_generator(cfg, *size)
    got = tcs.profile_spade_generator(to_port(cfg), *size)
    assert (got.macs, got.params, got.sections) == (want.macs, want.params, want.sections)
    for bcfg, tb in zip(cfg.blocks, to_port(cfg).blocks):
        assert tcs.profile_spade_block(tb, 8, 16) == jcs.profile_spade_block(bcfg, 8, 16)


# ---------------------------------------------------------------------------
# Gammas and the shrink
# ---------------------------------------------------------------------------


def _check_gammas(gen, cfg):
    got = tcs.collect_spade_gammas(gen.state_dict(), to_port(cfg))
    want = jcs.collect_spade_gammas(jax_variables(gen, cfg)["params"], cfg)
    np.testing.assert_array_equal(got.concat(), want.concat())
    return got


@pytest.mark.parametrize("target", [5.6e9, 3e10])
def test_shrink_recipe_teacher_equals_jax(target):
    """The recipe's ngf-64 teacher with seeded scales: the threshold, the
    searched MACs and the student config (as JSON) at the two student
    recipes' budgets, with the recipe's --prune_cin_lb 16 absent and
    present."""
    cfg = recipe_cfg()
    gen = seeded_generator(cfg, seed=3)
    _check_gammas(gen, cfg)
    jvars = jax_variables(gen, cfg)
    for lb in (1, 16):
        want = jcs.shrink_spade_generator(cfg, jvars, target, 256, 512, JBounds(cin_lb=lb))
        got = tcs.shrink_spade_generator(to_port(cfg), gen.state_dict(), target, 256, 512,
                                         PruneBounds(cin_lb=lb))
        assert (got.threshold, got.searched_macs) == (want.threshold, want.searched_macs)
        assert got.searched_macs <= target
        assert tcfg.config_to_json(got.config) == jcfg.config_to_json(want.config)


@pytest.mark.parametrize("tied", [False, True])
def test_shrink_tiny_with_pruned_branches_equals_jax(tied):
    """A tiny generator whose leading branches are pruned away (the port's
    ModuleLists index only the branches that exist), with distinct or tied
    scales, at three budgets and with a cap on the trunk."""
    cfg = with_pruned_branches(tiny_cfg(ngf=8))
    gen = seeded_generator(cfg, seed=4, tied=tied)
    g = _check_gammas(gen, cfg)
    if tied:
        assert np.unique(g.concat()).size <= 4
    jvars = jax_variables(gen, cfg)
    full = jcs.profile_spade_generator(cfg, 32, 64).macs
    for frac, ub in ((0.8, None), (0.5, None), (0.3, 4), (0.5, 1)):
        target = frac * full
        try:
            want = jcs.shrink_spade_generator(cfg, jvars, target, 32, 64, JBounds(cin_ub=ub))
        except ValueError as e:
            with pytest.raises(ValueError, match="unreachable"):
                tcs.shrink_spade_generator(to_port(cfg), gen.state_dict(), target, 32, 64,
                                           PruneBounds(cin_ub=ub))
            assert "unreachable" in str(e)
            continue
        got = tcs.shrink_spade_generator(to_port(cfg), gen.state_dict(), target, 32, 64,
                                         PruneBounds(cin_ub=ub))
        assert (got.threshold, got.searched_macs) == (want.threshold, want.searched_macs)
        assert tcfg.config_to_json(got.config) == jcfg.config_to_json(want.config)
        tspade.SPADEGenerator(got.config)  # the student builds


# ---------------------------------------------------------------------------
# The weight transfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
def test_transfer_equals_jax_bit_for_bit(rng, tied):
    """The pretrained generator's weights into a shrunk student (leading
    branches pruned, learned shortcuts, pruned nested SPADE branches): the
    port's parameters equal the JAX package's, carried, exactly; the
    statistics keep the student's fresh values; the student runs."""
    src_cfg = with_pruned_branches(tiny_cfg(ngf=8))
    gen = seeded_generator(src_cfg, seed=5, tied=tied)
    with torch.no_grad():  # magnitudes with ties under |w| when tied
        for name, p in gen.named_parameters():
            if p.dim() == 4 and tied:
                p.copy_(torch.from_numpy(rng.choice([-0.5, 0.5, 1.0], p.shape).astype(np.float32)))
    res = tcs.shrink_spade_generator(to_port(src_cfg), gen.state_dict(),
                                     0.4 * tcs.profile_spade_generator(to_port(src_cfg), 32,
                                                                       64).macs, 32, 64)
    dst_cfg = jcfg.config_from_json(tcfg.config_to_json(res.config))
    got = transfer_spade_generator_params(gen.state_dict(), to_port(src_cfg), res.config)
    want = jtransfer(jax_variables(gen, src_cfg)["params"], src_cfg, dst_cfg)
    carried = jax_import.spade_generator_state_dict(want, res.config)
    student = tspade.SPADEGenerator(res.config)
    params = dict(student.named_parameters())
    assert got.keys() == params.keys()
    for k, v in got.items():
        assert v.shape == params[k].shape, k
        assert torch.equal(v, carried[k]), k
    fresh = student.state_dict()
    student.load_state_dict({**fresh, **got})
    y = student(torch.from_numpy(rng.rand(2, 5, 32, 64).astype(np.float32)), train=True)
    assert y.shape == (2, 3, 32, 64) and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="num_upsampling_layers or semantic_nc"):
        transfer_spade_generator_params(gen.state_dict(), to_port(src_cfg),
                                        dataclasses.replace(res.config, semantic_nc=6))


# ---------------------------------------------------------------------------
# Reference checkpoints
# ---------------------------------------------------------------------------


def test_reference_fixture_loads_as_the_jax_package_reads_it(tmp_path):
    """The reference fixture's ``.pth``: the recovered config equals the JAX
    package's and the strict load gives the reference output (atol 1e-5)."""
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd/")}
    path = str(tmp_path / "ref.pth")
    torch.save(sd, path)
    kw = dict(num_upsampling_layers="normal", crop_size=32, aspect_ratio=1.0)
    cfg, state = timport.load_torch_spade_generator(path, **kw)
    want, _ = jimport.import_spade_generator({k: v.numpy() for k, v in sd.items()}, **kw)
    assert tcfg.config_to_json(cfg) == jcfg.config_to_json(want)
    assert tcfg.config_to_json(timport.recover_spade_config(sd, **kw)) == \
        jcfg.config_to_json(jimport.recover_spade_config({k: v.numpy() for k, v in sd.items()},
                                                         **kw))
    gen = tspade.SPADEGenerator(cfg)
    gen.load_state_dict(state)
    with torch.no_grad():
        got = gen(torch.from_numpy(data["seg"]))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), data["ref"], rtol=0, atol=1e-5)


def test_port_student_pth_reads_in_the_jax_package(rng, tmp_path):
    """A shrunk student's ``.pth`` as the port's distill verb saves it
    (parameters and statistics) read by the JAX package's
    ``load_torch_spade_generator``: the student's MACs and the port's eval
    output; the port's own loader recovers the JAX package's config."""
    from cat_tpu_torch.utils import checkpoint as ckpt

    cfg = with_pruned_branches(tiny_cfg(ngf=8))
    gen = seeded_generator(cfg, seed=6)
    res = tcs.shrink_spade_generator(to_port(cfg), gen.state_dict(),
                                     0.5 * jcs.profile_spade_generator(cfg, 32, 64).macs, 32, 64)
    student = seeded_generator(jcfg.config_from_json(tcfg.config_to_json(res.config)), seed=7)
    path = ckpt.save_net(str(tmp_path), "latest", "G", student.state_dict())
    kw = dict(num_upsampling_layers="normal", crop_size=64, aspect_ratio=2.0)
    jc, jv = jimport.load_torch_spade_generator(path, **kw)
    tc, _ = timport.load_torch_spade_generator(path, **kw)
    assert tcfg.config_to_json(tc) == jcfg.config_to_json(jc)
    # shapes cannot show a pruned-away branch's place: the recovered widths
    # are the student's without their zeros
    assert jcs.profile_spade_generator(jc, 32, 64).macs == res.searched_macs
    seg = (rng.rand(2, 32, 64, 5) > 0.5).astype(np.float32)
    want = jax.jit(lambda v, s: jspade.SPADEGenerator(jc).apply(v, s))(jv, jnp.asarray(seg))
    with torch.no_grad():
        got = student(torch.from_numpy(seg.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
