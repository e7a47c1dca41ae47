"""Teacher training's modules and the pix2pix task against the JAX package
(CPU, float32, tiny sizes, inputs made with numpy from a seed): batch norm,
the pixel and NLayer discriminators under it, the gradient penalty, the
image pool, and ``Pix2PixTask`` after 1 and 3 steps.

The JAX package's tasks run a train-mode forward of a net with tracked
batch norm outside ``mutable_stats`` at several sites (pix2pix's D in the G
loss and the penalty, CycleGAN's generators and D in the G loss, the
distiller's D), which flax refuses (``ModifyScopeVariableError``).  Their
evident meaning is "batch statistics, running statistics left alone", which
the port implements (``ops/nn.py::frozen_stats``).  So the tests run those
forwards mutable and discard their writes (``jax_stats_left_alone``),
without changing ``cat_tpu``.  The mixed penalty's draws are fixed on both
sides (``fixed_alpha``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cat_tpu.distill.inception_distiller as jdistill
import cat_tpu.models.losses as jlosses
import cat_tpu.train.cyclegan as jcyclegan
import cat_tpu.train.pix2pix as jpix2pix
from cat_tpu.core import config as jcfg
from cat_tpu.models.discriminators import NLayerDiscriminator as JNLayer
from cat_tpu.models.discriminators import PixelDiscriminator as JPixel
from cat_tpu.ops import nn as jnn
from cat_tpu.utils.image_pool import pool_init, pool_query
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.models import losses as tlosses
from cat_tpu_torch.models.discriminators import NLayerDiscriminator, PixelDiscriminator
from cat_tpu_torch.ops import nn as tnn
from cat_tpu_torch.train.pix2pix import Pix2PixHParams, Pix2PixTask
from cat_tpu_torch.utils import jax_import
from cat_tpu_torch.utils.image_pool import ImagePool
from tests.conftest import fast_init

torch.set_num_threads(1)

SIZE = 32
LR = 2e-4
ALPHA = np.array([0.3, 0.8], np.float32)  # the mixed penalty's weights, batch 2


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# JAX-side harness
# ---------------------------------------------------------------------------


def jax_stats_left_alone(mp):
    """Run the JAX tasks' non-mutable train-mode forwards of nets with
    running statistics as mutable ones whose writes are discarded."""
    orig = jpix2pix.apply_net

    def apply_net(module, params, stats, *args, train=False, mutable_stats=False, **kw):
        if stats and train and not mutable_stats:
            out, _ = orig(module, params, stats, *args, train=True, mutable_stats=True, **kw)
            return out, stats
        return orig(module, params, stats, *args, train=train, mutable_stats=mutable_stats, **kw)

    for mod in (jpix2pix, jcyclegan, jdistill):
        mp.setattr(mod, "apply_net", apply_net)


class _FixedUniform:
    """``jax`` as ``cat_tpu.models.losses`` sees it, with ``random.uniform``
    returning ``ALPHA``."""

    def __getattr__(self, name):
        return getattr(jax, name)

    class random:  # noqa: N801
        def __getattr__(self, name):
            return getattr(jax.random, name)

    random = random()
    random.uniform = staticmethod(
        lambda key, shape=(), dtype=jnp.float32, *a, **k: jnp.asarray(ALPHA, dtype).reshape(shape))


def fixed_alpha(mp):
    mp.setattr(jlosses, "jax", _FixedUniform())
    mp.setattr(tlosses, "mixing_weights",
               lambda n, generator, like: torch.from_numpy(ALPHA).reshape(n, 1, 1, 1).to(like))


# ---------------------------------------------------------------------------
# Batch norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["batch", "syncbatch"])
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm_matches_jax(rng, kind, track, affine):
    """Two train-mode forwards (the running statistics move after each when
    tracked), then eval mode: outputs and statistics."""
    norm = jcfg.NormConfig(kind=kind, affine=affine, track_running_stats=track, momentum=0.2)
    xs = [(rng.randn(3, 5, 7, 6) * 3 + 2).astype(np.float32) for _ in range(2)]
    jm = jnn.Norm2d(norm)
    variables = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    m = tnn.Norm2d(to_port(norm), 6)
    sd = {}
    if affine:
        scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
        variables["params"] = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
        sd = {"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    if track:
        sd.update(running_mean=torch.zeros(6), running_var=torch.ones(6),
                  num_batches_tracked=torch.tensor(0))  # a reference checkpoint's counter
    m.load_state_dict(sd)
    for i, x in enumerate(xs):
        if track:
            ref, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
            variables["batch_stats"] = new["batch_stats"]
        else:
            ref = jm.apply(variables, jnp.asarray(x), train=True)
        _close(nhwc(m(nchw(x), train=True)), ref, f"train forward {i}")
        if track:
            _close(m.running_mean, variables["batch_stats"]["mean"], "running mean")
            _close(m.running_var, variables["batch_stats"]["var"], "running var")
    with tnn.frozen_stats(m):  # batch statistics, running ones left alone
        before = {k: v.clone() for k, v in m.state_dict().items()}
        m(nchw(xs[0]), train=True)
        assert all(torch.equal(v, m.state_dict()[k]) for k, v in before.items())
    _close(nhwc(m(nchw(xs[0]))), jm.apply(variables, jnp.asarray(xs[0]), train=False), "eval")


# ---------------------------------------------------------------------------
# Discriminators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net, kind", [("pixel", "instance"), ("pixel", "batch"),
                                       ("nlayer", "batch")])
def test_discriminators_match_jax(rng, net, kind):
    """The pixel D, and the NLayer D under a tracked batch norm (convs
    without bias), from the JAX weights and statistics: train mode with the
    statistics moved, then eval mode."""
    norm = jcfg.NormConfig(kind=kind, affine=True, track_running_stats=kind == "batch")
    if net == "pixel":
        jcfg_ = jcfg.PixelDiscriminatorConfig(input_nc=6, ndf=8, norm=norm)
        jm, tm = JPixel(jcfg_), PixelDiscriminator(to_port(jcfg_))
        convert = jax_import.pixel_discriminator_state_dict
    else:
        jcfg_ = jcfg.NLayerDiscriminatorConfig(input_nc=6, ndf=8, norm=norm)
        jm, tm = JNLayer(jcfg_), NLayerDiscriminator(to_port(jcfg_))
        convert = jax_import.nlayer_discriminator_state_dict
    variables = dict(fast_init(jm, jnp.zeros((1, SIZE, SIZE, 6)), seed=3))
    if "batch_stats" in variables:  # statistics away from (0, 1)
        variables["batch_stats"] = jax.tree.map(
            lambda v: (rng.rand(*v.shape) + 0.5).astype(np.float32), variables["batch_stats"])
    tm.load_state_dict(convert(variables["params"], jcfg_, variables.get("batch_stats")))
    convs_feeding_norms = ("net.2", "net.5") if net == "pixel" else ("model.2", "model.5")
    assert all((f"{k}.bias" in tm.state_dict()) == (kind == "instance")
               for k in convs_feeding_norms)
    x = rng.randn(2, SIZE, SIZE, 6).astype(np.float32)
    _close(nhwc(tm(nchw(x))), jm.apply(variables, jnp.asarray(x)), "eval", 1e-4)
    if kind == "batch":
        ref, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        _close(nhwc(tm(nchw(x), train=True)), ref, "train", 1e-4)
        want = convert(variables["params"], jcfg_, new["batch_stats"])
        for k, v in tm.state_dict().items():
            if "running" in k:
                _close(v, want[k], k)


# ---------------------------------------------------------------------------
# Gradient penalty
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gp_type", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(rng, monkeypatch, gp_type):
    """The penalty through an NLayer D under an untracked batch norm, its
    input gradient, and its gradient with respect to D's parameters (the
    double backward), with α fixed for the mixed type."""
    fixed_alpha(monkeypatch)
    norm = jcfg.NormConfig(kind="batch", affine=True)
    dcfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8, norm=norm)
    variables = fast_init(JNLayer(dcfg), jnp.zeros((1, SIZE, SIZE, 3)), seed=5)
    real, fake = (rng.randn(2, SIZE, SIZE, 3).astype(np.float32) for _ in range(2))

    def jax_penalty(params):
        return jlosses.gradient_penalty(
            lambda x: JNLayer(dcfg).apply({"params": params}, x, train=True),
            jnp.asarray(real), jnp.asarray(fake), rng=jax.random.PRNGKey(0), gp_type=gp_type)

    ref, ref_grads = jax_penalty(variables["params"])
    ref_dparams = jax.grad(lambda p: jax_penalty(p)[0])(variables["params"])
    d = NLayerDiscriminator(to_port(dcfg))
    d.load_state_dict(jax_import.nlayer_discriminator_state_dict(variables["params"], dcfg))
    gp, grads = tlosses.gradient_penalty(lambda x: d(x, train=True), nchw(real), nchw(fake),
                                         gp_type=gp_type)
    _close(float(gp.detach()), float(ref), "penalty", rtol=1e-5, atol=0)
    _close(nhwc(grads), ref_grads, "input gradient", rtol=1e-4, atol=1e-7)
    names = list(dict(d.named_parameters()))
    # the output conv's bias does not reach the input gradient: zero, as jax.grad gives
    got = dict(zip(names, torch.autograd.grad(gp, list(d.parameters()), allow_unused=True,
                                              materialize_grads=True)))
    want = jax_import.nlayer_discriminator_state_dict(ref_dparams, dcfg)
    for k in names:
        _close(got[k], want[k], k, rtol=1e-4, atol=1e-6)
    zero, none = tlosses.gradient_penalty(lambda x: d(x, train=True), nchw(real), nchw(fake),
                                          lambda_gp=0.0)
    assert float(zero) == 0.0 and none is None


# ---------------------------------------------------------------------------
# Image pool
# ---------------------------------------------------------------------------


def test_pool_filling_is_bit_equal_to_pool_query(rng):
    """While the pool fills, images are stored and returned as they are: the
    same buffer and outputs as the JAX package's ``pool_query``."""
    jstate = pool_init(5, 4, 3, 2)
    pool = ImagePool(5, 2, 4, 3)
    for n in (2, 2, 1):
        x = rng.randn(n, 4, 3, 2).astype(np.float32)
        jstate, jout = pool_query(jstate, jnp.asarray(x), jax.random.PRNGKey(n))
        out = pool.query(nchw(x))
        np.testing.assert_array_equal(nhwc(out), np.asarray(jout))
        np.testing.assert_array_equal(nhwc(pool.buffer), np.asarray(jstate.buffer))
        assert pool.count == int(jstate.count)


def test_full_pool_swaps_half_the_images():
    """Once full, each image comes back itself or as a pool entry, which the
    image then replaces (image by image, so a later image of the batch may
    get an earlier one back); the swap share over 2000 images is 0.5 ± 0.1."""
    pool = ImagePool(4, 1, 1, 1, seed=3)
    held = list(range(4))
    pool.query(torch.tensor(held, dtype=torch.float32).reshape(4, 1, 1, 1))
    swaps, value = 0, 4
    for _ in range(250):
        batch = torch.arange(value, value + 8, dtype=torch.float32).reshape(8, 1, 1, 1)
        out = pool.query(batch).flatten().tolist()
        for sent, got in zip(range(value, value + 8), out):
            if got != sent:
                assert got in held
                held[held.index(got)] = sent
                swaps += 1
        value += 8
        assert sorted(held) == sorted(pool.buffer.flatten().tolist())
    assert abs(swaps / 2000 - 0.5) <= 0.1
    assert pool.count == 4


# ---------------------------------------------------------------------------
# Pix2PixTask
# ---------------------------------------------------------------------------


CASES = {"instance-hinge": ("instance", "hinge"), "batch-lsgan": ("batch", "lsgan"),
         "batch-wgangp": ("batch", "wgangp")}


def _pix2pix_cfgs(kind):
    norm = jcfg.NormConfig(kind=kind, affine=True, track_running_stats=kind == "batch")
    g = jcfg.InceptionGeneratorConfig.make(ngf=4, channels_reduction_factor=2,
                                           kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm)
    return g, jcfg.NLayerDiscriminatorConfig(input_nc=6, ndf=8, norm=norm)


def _params_close(got, want, steps, what):
    assert got.keys() == want.keys(), what
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    # Adam's ±lr on float32-noise gradients (ROADMAP queue 3)
    assert worst <= 2.5 * LR * steps, (what, worst)


@pytest.mark.parametrize("case", list(CASES))
def test_pix2pix_task_matches_jax(rng, monkeypatch, case):
    """Losses after 1 and 3 steps at rtol 1e-4, parameters within
    2.5·lr·steps, running statistics of G and D at rtol 1e-5."""
    jax_stats_left_alone(monkeypatch)
    fixed_alpha(monkeypatch)
    kind, mode = CASES[case]
    gcfg, dcfg = _pix2pix_cfgs(kind)
    jtask = jpix2pix.Pix2PixTask(gcfg, dcfg, jpix2pix.Pix2PixHParams(gan_mode=mode))
    jstate = jtask.init_state(jax.random.PRNGKey(0), SIZE, SIZE)
    task = Pix2PixTask(to_port(gcfg), to_port(dcfg), Pix2PixHParams(gan_mode=mode),
                       device="cpu")
    state = task.init_state(0, jax_import.generator_state_dict(jstate.g.params, gcfg,
                                                               jstate.g.stats))
    task.netD.load_state_dict(jax_import.nlayer_discriminator_state_dict(
        jstate.d.params, dcfg, jstate.d.stats))
    batch = {k: rng.randn(2, SIZE, SIZE, 3).astype(np.float32) for k in "AB"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: nchw(v) for k, v in batch.items()}
    for step in (1, 2, 3):
        jstate, jm = jtask.train_step(jstate, jbatch, LR)
        state, tm = task.train_step(state, tbatch, LR)
        if step == 2:
            continue
        assert tm.keys() == jm.keys()
        for k in jm:
            _close(float(tm[k]), float(jm[k]), f"step {step} {k}", rtol=1e-4, atol=1e-6)
        g_ref = jax_import.generator_state_dict(jstate.g.params, gcfg, jstate.g.stats)
        d_ref = jax_import.nlayer_discriminator_state_dict(jstate.d.params, dcfg,
                                                           jstate.d.stats)
        for name, ref, net in (("G", g_ref, task.netG), ("D", d_ref, task.netD)):
            got = net.state_dict()
            _params_close({k: got[k] for k in state_names(net, False)},
                          {k: ref[k] for k in state_names(net, False)}, step, name)
            for k in state_names(net, True):
                _close(got[k], ref[k], f"step {step} {name} {k}", rtol=1e-5, atol=1e-6)
        assert bool(state_names(task.netG, True)) == (kind == "batch")
    assert state.step == 3
    x = tbatch["A"]
    _close(nhwc(task.generate(state, x)), jtask.generate(jstate, jbatch["A"]), "generate",
           rtol=1e-4, atol=1e-4)


def state_names(net, stats: bool):
    names = dict(net.named_buffers()) if stats else dict(net.named_parameters())
    return sorted(names)


def test_pix2pix_running_stats_move_only_where_the_jax_task_moves_them(rng):
    """One step with tracked batch norm: G's statistics move once (its one
    forward), D's twice (fake, then real); the G loss's D forward and the
    penalty's leave them.  Checked against a by-hand replay of those
    forwards on copies of the nets."""
    import copy

    gcfg, dcfg = _pix2pix_cfgs("batch")
    task = Pix2PixTask(to_port(gcfg), to_port(dcfg), Pix2PixHParams(gan_mode="wgangp"),
                       device="cpu")
    state = task.init_state(0)
    g0, d0 = copy.deepcopy(task.netG), copy.deepcopy(task.netD)
    a, b = (torch.from_numpy(rng.randn(2, 3, SIZE, SIZE).astype(np.float32)) for _ in "AB")
    task.train_step(state, {"A": a, "B": b}, LR)
    with torch.no_grad():
        fake = g0(a, train=True)
        d0(torch.cat([a, fake], 1), train=True)
        d0(torch.cat([a, b], 1), train=True)
    for net, ref in ((task.netG, g0), (task.netD, d0)):
        for k, v in ref.named_buffers():
            torch.testing.assert_close(dict(net.named_buffers())[k], v, rtol=1e-6, atol=1e-7)
