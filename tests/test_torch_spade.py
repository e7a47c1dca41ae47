"""The SPADE (GauGAN) family in the port against the JAX package (CPU,
float32, tiny sizes, inputs made with numpy from a seed): the spectral conv,
nearest resize, the generator against the reference fixture and the JAX
generator, the multiscale D, the VGG loss, the input preprocessing, the
Cityscapes items, ``SPADETask`` after 1 and 3 steps, and the train verb with
``--model spade``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cat_tpu.core import config as jcfg
from cat_tpu.core import spade_config as jsc
from cat_tpu.data import cityscapes as jcity
from cat_tpu.models import spade as jspade
from cat_tpu.models import vgg as jvgg
from cat_tpu.ops.spectral import SpectralConv as JSpectral
from cat_tpu.train import spade_model as jsm
from cat_tpu.utils.spade_import import import_spade_generator
from cat_tpu_torch import entry
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.data import cityscapes as tcity
from cat_tpu_torch.data.datasets import create_dataloader
from cat_tpu_torch.data.transforms import TransformSpec
from cat_tpu_torch.models import spade as tspade
from cat_tpu_torch.models import vgg as tvgg
from cat_tpu_torch.ops.nn import frozen_stats, init_weights
from cat_tpu_torch.ops.spectral import SpectralConv2d
from cat_tpu_torch.train import spade_model as tsm
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_spade_fixture.npz")
LR = 2e-4
H, W = 32, 64  # crop 64 at aspect 2, "normal" upsampling: a 1 x 2 latent


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _tiny_cfgs(kernel_sizes=(1, 3), spectral=False):
    """Generator (3 labels + dontcare + edges, ngf 2; spectral convs in its
    blocks with ``spectral``) and multiscale spectral D."""
    g = jsc.SPADEGeneratorConfig.make(semantic_nc=5, ngf=2, channels_reduction_factor=8,
                                      kernel_sizes=kernel_sizes, num_upsampling_layers="normal",
                                      crop_size=W, aspect_ratio=2.0, spectral=spectral)
    d = jsc.MultiscaleDiscriminatorConfig(input_nc=8, ndf=4, n_layers=3, num_D=2)
    return g, d


def _labels(rs, n=2):
    label = rs.randint(0, 3, (n, H, W)).astype(np.float32)
    label[:, :3, :5] = 255  # void
    inst = np.repeat(np.repeat(rs.randint(0, 4, (n, H // 8, W // 8)), 8, 1), 8, 2)
    return label, inst.astype(np.int32)


# ---------------------------------------------------------------------------
# Spectral conv, nearest resize
# ---------------------------------------------------------------------------


def test_spectral_conv_matches_jax(rng):
    """Forward, eval and train; ``u`` written only by a train forward that
    may write state (not under ``frozen_stats``), as the JAX package writes
    it only with the ``spectral`` collection mutable; the kernel's gradient
    with σ held constant."""
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    jm = JSpectral(5, 4, stride=2, padding=2)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    m = SpectralConv2d(6, 5, 4, stride=2, padding=2)
    sd = {"weight_orig": torch.from_numpy(np.asarray(variables["params"]["kernel"])
                                          .transpose(3, 2, 0, 1).copy()),
          "bias": torch.from_numpy(rng.randn(5).astype(np.float32)),
          "weight_u": torch.from_numpy(np.asarray(variables["spectral"]["u"]).copy()),
          "weight_v": torch.zeros(6 * 16)}
    m.load_state_dict(sd)
    params = {"kernel": variables["params"]["kernel"], "bias": jnp.asarray(sd["bias"].numpy())}
    u0 = sd["weight_u"].clone()
    want = jm.apply({"params": params, "spectral": variables["spectral"]}, jnp.asarray(x))
    _close(nhwc(m(nchw(x))), want, "eval forward")
    with frozen_stats(m):
        m(nchw(x), train=True)
    assert torch.equal(m.weight_u, u0)
    want, new = jm.apply({"params": params, "spectral": variables["spectral"]}, jnp.asarray(x),
                         train=True, mutable=["spectral"])
    _close(nhwc(m(nchw(x), train=True)), want, "train forward")
    _close(m.weight_u, new["spectral"]["u"], "u after a writing forward", rtol=1e-6, atol=1e-7)
    assert not torch.equal(m.weight_u, u0)

    # the gradient holds σ: the JAX package's (stop_gradient), not torch's spectral_norm's
    r = rng.randn(*want.shape).astype(np.float32)
    spectral = {"spectral": {"u": jnp.asarray(m.weight_u.numpy())}}
    jgrad = jax.grad(lambda p: jnp.sum(jm.apply({"params": p, **spectral}, jnp.asarray(x))
                                       * r))(params)
    (tgrad,) = torch.autograd.grad((m(nchw(x)) * nchw(r)).sum(), m.weight_orig)
    _close(tgrad.numpy().transpose(2, 3, 1, 0), jgrad["kernel"], "kernel gradient",
           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((16, 32), (4, 8)), ((4, 8), (16, 32)), ((12, 20), (5, 7)),
                                     ((5, 7), (12, 20)), ((8, 8), (8, 8))])
def test_nearest_resize_is_jax_and_torch_nearest(rng, src, dst):
    x = rng.randn(2, 3, *src).astype(np.float32)
    got = tspade.nearest_resize(torch.from_numpy(x), *dst)
    _close(nhwc(got), jspade.nearest_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), *dst),
           "jax", rtol=0, atol=0)
    torch.testing.assert_close(got, torch.nn.functional.interpolate(torch.from_numpy(x), dst),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------


def test_spade_generator_matches_fixture_and_jax(rng):
    """The reference's state_dict loads strictly and gives its output (atol
    1e-5, as tests/test_spade_import.py holds the JAX generator); the port's
    state_dict through ``import_spade_generator`` gives the JAX generator's
    eval output, and the JAX tree comes back to the same state_dict."""
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd/")}
    jcfg_, _ = import_spade_generator({k: v.numpy() for k, v in sd.items()},
                                      num_upsampling_layers="normal", crop_size=32,
                                      aspect_ratio=1.0)
    gen = tspade.SPADEGenerator(to_port(jcfg_))
    gen.load_state_dict(sd)
    seg = torch.from_numpy(data["seg"])
    _close(nhwc(gen(seg)), data["ref"], "reference fixture", rtol=0, atol=1e-5)

    with torch.no_grad():
        for name, buf in gen.named_buffers():
            buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
    _, variables = import_spade_generator({k: v.numpy() for k, v in gen.state_dict().items()},
                                          cfg=jcfg_)
    want = jax.jit(lambda v, s: jspade.SPADEGenerator(jcfg_).apply(v, s))(
        variables, jnp.asarray(data["seg"].transpose(0, 2, 3, 1)))
    _close(nhwc(gen(seg)), want, "JAX eval output", rtol=1e-4, atol=1e-5)
    back = jax_import.spade_generator_state_dict(variables["params"], to_port(jcfg_),
                                                 {"batch_stats": variables["batch_stats"]})
    assert back.keys() == gen.state_dict().keys()
    assert all(torch.equal(back[k], v) for k, v in gen.state_dict().items())


def test_multiscale_discriminator_matches_jax(rng):
    """Every scale's features and logits, D's ``u`` carried, and the ``u``
    a writing train forward leaves."""
    _, dcfg = _tiny_cfgs()
    x = rng.randn(2, H, W, 8).astype(np.float32)
    jd = jspade.MultiscaleDiscriminator(dcfg)
    variables = jd.init(jax.random.PRNGKey(2), jnp.asarray(x))
    d = tspade.MultiscaleDiscriminator(to_port(dcfg))
    d.load_state_dict(jax_import.multiscale_discriminator_state_dict(
        variables["params"], dcfg, {"spectral": variables["spectral"]}))
    want, new = jd.apply(variables, jnp.asarray(x), train=True, mutable=["spectral"])
    got = d(nchw(x), train=True)
    assert [len(s) for s in got] == [len(s) for s in want] == [4, 4]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            _close(nhwc(g), w, f"features {w.shape}", rtol=1e-4, atol=1e-5)
    ref = jax_import.multiscale_discriminator_state_dict(variables["params"], dcfg, new)
    for k, v in d.state_dict().items():
        _close(v, ref[k], k, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spectral", [False, True])
def test_packed_spade_generator_matches_unpacked_and_jax(rng, spectral):
    """The packed layout (the default) against the unpacked one and against
    the JAX package's packed generator, leading branches pruned so that a
    branch's place differs from its config index (kernels 1, 3, 5, learned
    shortcuts): the eval output, the train-mode output, and the running
    statistics and spectral ``u`` one train forward leaves; a train forward
    under ``frozen_stats`` writes nothing.  The state_dict is the same."""
    from tests.test_torch_spade_compress import with_pruned_branches

    jc = with_pruned_branches(jsc.SPADEGeneratorConfig.make(
        semantic_nc=5, ngf=4, channels_reduction_factor=4, kernel_sizes=(1, 3, 5),
        num_upsampling_layers="normal", crop_size=W, aspect_ratio=2.0, nhidden=16,
        spectral=spectral))
    jgen = jspade.SPADEGenerator(jc, packed_blocks=True)
    seg = (rng.rand(2, H, W, 5) > 0.6).astype(np.float32)
    rs = np.random.RandomState(3)

    def spread(path, x):  # norm scales and running statistics away from their start
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(rs.uniform(0.5, 1.5, x.shape), jnp.float32)
        return jnp.asarray(rs.randn(*x.shape) * 0.1, jnp.float32) if name == "mean" else x

    variables = jax.tree_util.tree_map_with_path(
        spread, fast_init(jgen, jnp.zeros((1, H, W, 5)), seed=3))
    packed = tspade.SPADEGenerator(to_port(jc))
    packed.load_state_dict(jax_import.spade_generator_state_dict(
        variables["params"], to_port(jc), variables))
    unpacked = tspade.SPADEGenerator(to_port(jc), packed_blocks=False)
    unpacked.load_state_dict(packed.state_dict())
    tseg = nchw(seg)

    want = np.asarray(jax.jit(lambda v, s: jgen.apply(v, s))(variables, jnp.asarray(seg)))
    scale = np.abs(want).max()
    with torch.no_grad():
        got = packed(tseg)
        _close(nhwc(got), nhwc(unpacked(tseg)), "eval, unpacked", rtol=1e-4, atol=1e-5 * scale)
    _close(nhwc(got), want, "eval, JAX", rtol=1e-4, atol=1e-5 * scale)

    muts = ["batch_stats", "spectral"] if spectral else ["batch_stats"]
    want, new = jax.jit(lambda v, s: jgen.apply(v, s, train=True, mutable=muts))(
        variables, jnp.asarray(seg))
    scale = np.abs(np.asarray(want)).max()
    before = {k: v.clone() for k, v in packed.state_dict().items()}
    with torch.no_grad(), frozen_stats(packed):
        packed(tseg, train=True)
    assert all(torch.equal(v, before[k]) for k, v in packed.state_dict().items())
    with torch.no_grad():
        got = packed(tseg, train=True)
        _close(nhwc(got), nhwc(unpacked(tseg, train=True)), "train, unpacked", rtol=1e-4,
               atol=1e-5 * scale)
    _close(nhwc(got), want, "train, JAX", rtol=1e-4, atol=1e-5 * scale)
    ref = jax_import.spade_generator_state_dict(variables["params"], to_port(jc), new)
    moved = 0
    for k, v in packed.state_dict().items():
        if k.endswith("weight_v"):
            continue
        _close(v, unpacked.state_dict()[k], f"{k}, unpacked", rtol=1e-4, atol=1e-6)
        _close(v, ref[k], f"{k}, JAX", rtol=1e-4, atol=1e-6)
        moved += not torch.equal(v, before[k])
    assert moved >= len([k for k in before if "running" in k or k.endswith("weight_u")])


def test_packed_task_and_distiller_steps_match_unpacked(rng):
    """One ``SPADETask`` step and one ``SPADEDistiller`` step (KA, spectral
    student blocks, leading branches pruned) with ``packed_blocks`` give the
    unpacked steps' losses at rtol 1e-5, parameters within 2.5·lr (Adam's
    sign of float32 noise) and running statistics and ``u`` at rtol 1e-4."""
    import dataclasses

    from cat_tpu_torch.distill import spade_distiller as tsd
    from tests.test_torch_spade_compress import with_pruned_branches

    gcfg, dcfg = _tiny_cfgs(kernel_sizes=(1, 3), spectral=True)
    gcfg = to_port(with_pruned_branches(gcfg))
    label, inst = _labels(rng)
    batch = {"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
             "image": torch.from_numpy(rng.uniform(-1, 1, (2, 3, H, W)).astype(np.float32))}

    def compare(a, b, ma, mb):
        for k in ma:
            _close(float(ma[k]), float(mb[k]), k, rtol=1e-5, atol=1e-7)
        sa, sb = a.state_dict(), b.state_dict()
        params = dict(a.named_parameters())
        for k, v in sa.items():
            if k in params:
                assert float((v - sb[k]).abs().max()) <= 2.5 * LR, k
            elif not k.endswith("weight_v"):
                _close(v, sb[k], k, rtol=1e-4, atol=1e-6)

    tasks = []
    for packed in (True, False):
        task = tsm.SPADETask(gcfg, to_port(dcfg), tsm.SPADEHParams(packed_blocks=packed),
                             input_nc=3, contain_dontcare=True, device="cpu")
        state = task.init_state(0)
        tasks.append((task, *task.train_step(state, batch, LR)))
    assert tasks[0][0].netG.state_dict().keys() == tasks[1][0].netG.state_dict().keys()
    compare(tasks[0][0].netG, tasks[1][0].netG, tasks[0][2], tasks[1][2])

    teacher = tspade.SPADEGenerator(gcfg, generator=torch.Generator().manual_seed(1))
    scfg = dataclasses.replace(gcfg, blocks=tuple(
        dataclasses.replace(b, res_channels=tuple(c // 2 for c in b.res_channels))
        for b in gcfg.blocks))
    runs = []
    for packed in (True, False):
        dist = tsd.SPADEDistiller(gcfg, scfg, to_port(dcfg),
                                  tsd.SPADEDistillHParams(packed_blocks=packed, lambda_vgg=0.0),
                                  input_nc=3, contain_dontcare=True, device="cpu")
        state, tparams = dist.init_state(teacher.state_dict(), seed=2)
        runs.append((dist, *dist.train_step(state, tparams, batch, LR)))
    for (dist, _, _), packed in zip(runs, (True, False)):
        assert {m.packed for m in dist.netG_student.modules()
                if isinstance(m, (tspade.SPADEBlock, tspade.InceptionSPADENorm))} == {packed}
    compare(runs[0][0].netG_student, runs[1][0].netG_student, runs[0][2], runs[1][2])


def test_vgg_loss_matches_jax(rng):
    """Random torchvision-layout weights: the loss and its gradient into the
    fake; the target gets none.  bfloat16 sweeps stay near the float32 loss."""
    sd = tvgg.random_vgg19_state_dict(seed=3)
    model = tvgg.VGG19Features()
    model.load_state_dict(tvgg.vgg19_layout({**sd, "classifier.0.weight": torch.zeros(1)}))
    jv = jvgg.convert_torch_vgg19({k: v.numpy() for k, v in sd.items()})
    x, y = (rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32) for _ in range(2))
    jloss, jgrad = jax.value_and_grad(lambda a: jvgg.vgg_loss(jv, a, jnp.asarray(y)))(
        jnp.asarray(x))
    xt, yt = nchw(x).requires_grad_(True), nchw(y).requires_grad_(True)
    loss = tvgg.vgg_loss(model, xt, yt)
    (gx,) = torch.autograd.grad(loss, xt)
    _close(float(loss), float(jloss), "loss", rtol=1e-5, atol=0)
    _close(nhwc(gx), jgrad, "gradient", rtol=1e-3, atol=1e-7 * float(np.abs(jgrad).max()) * 1e3)
    assert yt.grad is None
    low = float(tvgg.vgg_loss(model, nchw(x), nchw(y), "bfloat16"))
    assert abs(low - float(loss)) < 0.05 * float(loss)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dontcare", [False, True])
def test_preprocess_input_matches_jax(rng, dontcare):
    label, inst = _labels(rng)
    want = jsm.preprocess_input(jnp.asarray(label), jnp.asarray(inst), 3, dontcare)
    got = tsm.preprocess_input(torch.from_numpy(label), torch.from_numpy(inst), 3, dontcare)
    assert got.shape == (2, 3 + dontcare + 1, H, W)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(
        nhwc(tsm.instance_edges(torch.from_numpy(inst))),
        np.asarray(jsm.instance_edges(jnp.asarray(inst))))


def write_cityscapes(root, n_train=4, n_val=2, size=(96, 48), rs=None):
    """Cityscapes' layout: gtFine/<phase>/<city>/*_labelIds.png and
    *_instanceIds.png, leftImg8bit/<phase>/<city>/*_leftImg8bit.png, seeded
    (labels 0-34 with some 255, instance ids in 8 x 8 blocks)."""
    rs = rs or np.random.RandomState(0)
    w, h = size
    for phase, n in (("train", n_train), ("val", n_val)):
        for sub in ("gtFine", "leftImg8bit"):
            os.makedirs(os.path.join(root, sub, phase, "synth"), exist_ok=True)
        for i in range(n):
            stem = os.path.join(root, "{}", phase, "synth", f"synth_{i:06d}_000019")
            label = rs.randint(0, 35, (h, w)).astype(np.uint8)
            label[: h // 8] = 255
            inst = np.repeat(np.repeat(rs.randint(0, 30000, (h // 8, w // 8)), 8, 0), 8, 1)
            Image.fromarray(label).save(stem.format("gtFine") + "_gtFine_labelIds.png")
            Image.fromarray(inst.astype(np.uint16)).save(stem.format("gtFine")
                                                        + "_gtFine_instanceIds.png")
            Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
                stem.format("leftImg8bit") + "_leftImg8bit.png")
    return root


def test_cityscapes_items_and_loader_match_jax(tmp_path):
    """Items (labels and instances NEAREST, photos BICUBIC, to (load, load /
    aspect)), the shuffled loader's order, ``max_size`` and the memory
    cache; a broken pairing raises unless unchecked."""
    root = write_cityscapes(str(tmp_path))
    kw = dict(load_size=64, crop_size=64, aspect_ratio=2.0)
    jds = jcity.CityscapesDataset(root, "train", **kw)
    tds = tcity.CityscapesDataset(root, "train", load_in_memory=True, **kw)
    assert len(tds) == len(jds) == 4
    for i in range(4):
        a, b = tds[i], jds[i]
        assert a["path"] == b["path"] and a["image"].shape == (3, 32, 64)
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["instance"], b["instance"])
        np.testing.assert_array_equal(a["image"], b["image"].transpose(2, 0, 1))
        assert tds[i] is a  # cached
    assert len(tcity.CityscapesDataset(root, "train", max_size=3, no_instance=True, **kw)) == 3
    tl = tcity.create_cityscapes_dataloader(root, 2, seed=5, num_workers=2, **kw)
    jl = jcity.create_cityscapes_dataloader(root, 2, seed=5, **kw)
    for a, b in zip(tl, jl):
        assert a["path"] == b["path"]
        np.testing.assert_array_equal(a["label"].numpy(), b["label"])
    # the generic factory's cityscapes mode builds the same loader
    spec = TransformSpec(load_size=64, crop_size=64, aspect_ratio=2.0)
    batch = next(iter(create_dataloader("cityscapes", root, 2, spec, serial_batches=True)))
    assert batch["image"].shape == (2, 3, 32, 64) and batch["instance"].dtype == torch.int32
    os.rename(os.path.join(root, "leftImg8bit", "train", "synth", "synth_000001_000019_"
                           "leftImg8bit.png"),
              os.path.join(root, "leftImg8bit", "train", "synth", "zz_leftImg8bit.png"))
    with pytest.raises(ValueError, match="pairing broken"):
        tcity.CityscapesDataset(root, "train", **kw)
    assert len(tcity.CityscapesDataset(root, "train", pairing_check=False, **kw)) == 4


# ---------------------------------------------------------------------------
# The task
# ---------------------------------------------------------------------------


def _jax_task(vgg_sd):
    """The JAX task (its family default: packed blocks) with one kernel
    size (its XLA compile dominates the test), its state from ``fast_init``
    (its init compiles for a minute)."""
    from cat_tpu.train.common import GANTrainState, NetState

    gcfg, dcfg = _tiny_cfgs(kernel_sizes=(3,))
    jtask = jsm.SPADETask(gcfg, dcfg, jsm.SPADEHParams(),
                          vgg_variables=jvgg.convert_torch_vgg19(
                              {k: v.numpy() for k, v in vgg_sd.items()}), input_nc=3)
    jtask.contain_dontcare = True
    opt_init = jax.jit(jtask.tx.init)

    def net(module, cin, seed):
        v = fast_init(module, jnp.zeros((1, H, W, cin)), seed=seed)
        return NetState(v["params"], opt_init(v["params"]),
                        {k: x for k, x in v.items() if k != "params"})

    jstate = GANTrainState(step=jnp.zeros((), jnp.int32), g=net(jtask.netG, 5, 1),
                           d=net(jtask.netD, 8, 2), rng=jax.random.PRNGKey(0))
    return jtask, jstate


def _port_task(gcfg, dcfg, vgg_sd, g_sd, d_sd, **hp):
    vgg = tvgg.VGG19Features()
    vgg.load_state_dict(vgg_sd)
    task = tsm.SPADETask(to_port(gcfg), to_port(dcfg), tsm.SPADEHParams(**hp), vgg=vgg,
                         input_nc=3, contain_dontcare=True, device="cpu")
    state = task.init_state(0, g_sd)
    task.netD.load_state_dict(d_sd)
    return task, state


def test_spade_task_matches_jax(rng, tmp_path):
    """Losses after 1 and 3 steps at rtol 1e-4; parameters within
    2.5·lr·steps of each net's TTUR rate (G lr/2, D 2·lr); G's running
    statistics (moved by the G step's forward only) and D's ``u`` (written
    by the D step only) against the JAX task's; eval generation after 3
    steps at a tolerance scaled to its size, and after 9 steps (the chip's
    GauGAN run's count) as flat as the JAX task's; the JAX task's saved
    state restores into the port exactly."""
    vgg_sd = tvgg.random_vgg19_state_dict(seed=4)
    jtask, jstate = _jax_task(vgg_sd)
    gcfg, dcfg = jtask.gen_cfg, jtask.disc_cfg
    task, state = _port_task(gcfg, dcfg, vgg_sd, jax_import.spade_generator_state_dict(
        jstate.g.params, to_port(gcfg), jstate.g.stats),
        jax_import.multiscale_discriminator_state_dict(jstate.d.params, to_port(dcfg),
                                                       jstate.d.stats))
    label, inst = _labels(rng)
    image = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    jbatch = {"label": jnp.asarray(label), "instance": jnp.asarray(inst),
              "image": jnp.asarray(image)}
    tbatch = {"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
              "image": nchw(image)}
    for step in range(1, 10):
        jstate, jm = jtask.train_step(jstate, jbatch, LR)
        state, tm = task.train_step(state, tbatch, LR)
        if step == 9:
            # xavier at gain 0.02 and running statistics near their start
            # make the eval-mode image small in both packages; the port's is
            # as small as JAX's and follows it (Adam's sign noise on
            # near-zero gradients moves them ~1% of its size apart by now)
            got = np.asarray(nhwc(task.generate_raw(state, tbatch)))
            want = np.asarray(jtask.generate_raw(jstate, jbatch))
            _close(got.std(), want.std(), "step 9 eval-mode std", rtol=0.05, atol=0)
            _close(got, want, "step 9 generate_raw", rtol=0, atol=0.05 * np.abs(want).max())
        if step not in (1, 3):
            continue
        assert list(tm) == ["G_loss/gan", "G_loss/feat", "G_loss/vgg", "D_loss/fake",
                            "D_loss/real"]
        assert tm.keys() == jm.keys()
        for k in jm:
            _close(float(tm[k]), float(jm[k]), f"step {step} {k}", rtol=1e-4, atol=1e-6)
        for name, net, ref, lr in (
                ("G", task.netG, jax_import.spade_generator_state_dict(
                    jstate.g.params, task.gen_cfg, jstate.g.stats), LR / 2),
                ("D", task.netD, jax_import.multiscale_discriminator_state_dict(
                    jstate.d.params, task.disc_cfg, jstate.d.stats), 2 * LR)):
            got = net.state_dict()
            assert got.keys() == ref.keys()
            params = dict(net.named_parameters())
            worst = max(float((got[k] - ref[k]).abs().max()) for k in params)
            assert worst <= 2.5 * lr * step, (name, step, worst)
            # statistics and u follow the parameters, which Adam's sign noise
            # moves apart from step 2 on; weight_v is informational (the carry
            # derives it from the new kernel, the step from the old one)
            tol = dict(rtol=1e-4, atol=1e-6) if step == 1 else dict(rtol=1e-3, atol=2.5 * LR * step)
            for k in dict(net.named_buffers()):
                if not k.endswith("weight_v"):
                    _close(got[k], ref[k], f"step {step} {name} {k}", **tol)
        if step == 3:
            want = np.asarray(jtask.generate_raw(jstate, jbatch))
            _close(nhwc(task.generate_raw(state, tbatch)), want, "step 3 generate_raw",
                   rtol=1e-3, atol=1e-4 * np.abs(want).max())

    from cat_tpu.utils import checkpoint as jckpt
    from cat_tpu_torch.train.common import load_train_state_dict

    path = jckpt.save_train_state(str(tmp_path), "latest", jstate)
    fresh = tsm.SPADETask(task.gen_cfg, task.disc_cfg, tsm.SPADEHParams(), device="cpu")
    restored = load_train_state_dict(fresh.init_state(1), jax_import.train_state_dict(
        ckpt.load_pytree(path), "spade", task.gen_cfg, task.disc_cfg))
    assert restored.step == 9 and restored.g.opt.count == restored.d.opt.count == 9
    want = jax_import.multiscale_discriminator_state_dict(jstate.d.params, task.disc_cfg,
                                                          jstate.d.stats)
    assert all(torch.equal(v, want[k]) for k, v in fresh.netD.state_dict().items())


@pytest.mark.parametrize("spectral_g", [False, True])
def test_spade_task_writes_state_only_where_the_jax_task_does(rng, spectral_g):
    """One step, replayed by hand on copies: G's running statistics (and,
    with spectral blocks, its ``u``) are the G step's forward's (the D
    step's regeneration leaves them); D's ``u`` is the D step's one writing
    forward's (the G step's D forward leaves it).  With ``remat`` the step's
    losses and state are the same (the recompute starts from the ``u`` the
    forward started from)."""
    import copy

    gcfg, dcfg = _tiny_cfgs(spectral=spectral_g)
    vgg_sd = tvgg.random_vgg19_state_dict(seed=4)
    task, state = _port_task(gcfg, dcfg, vgg_sd, None, tspade.MultiscaleDiscriminator(
        to_port(dcfg), generator=torch.Generator().manual_seed(1)).state_dict())
    label, inst = _labels(rng)
    batch = {"label": torch.from_numpy(label), "instance": torch.from_numpy(inst),
             "image": torch.from_numpy(rng.uniform(-1, 1, (2, 3, H, W)).astype(np.float32))}
    g0, d0 = copy.deepcopy(task.netG), copy.deepcopy(task.netD)
    remat, rstate = _port_task(gcfg, dcfg, vgg_sd, g0.state_dict(), d0.state_dict(), remat=True)
    _, m = task.train_step(state, batch, LR)
    _, rm = remat.train_step(rstate, batch, LR)
    for k in m:
        _close(float(rm[k]), float(m[k]), k, rtol=1e-5, atol=1e-7)
    for a, b in ((remat.netG, task.netG), (remat.netD, task.netD)):
        for k, v in a.state_dict().items():
            _close(v, b.state_dict()[k], k, rtol=1e-5, atol=1e-6)
    sem = tsm.preprocess_input(batch["label"], batch["instance"], 3, True)
    with torch.no_grad():
        g0(sem, train=True)  # the G step's forward, on the old weights
        # one power iteration from D's old kernels and u, whatever the input
        d0(torch.cat([sem, batch["image"]], 1), train=True)
    for net, ref in ((task.netG, g0), (task.netD, d0)):
        for k, v in ref.named_buffers():
            torch.testing.assert_close(net.get_buffer(k), v, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The train verb
# ---------------------------------------------------------------------------


SPADE_TINY = ["--model", "spade", "--dataset_mode", "cityscapes", "--ngf", "2",
              "--channels_reduction_factor", "8", "--kernel_sizes", "1", "3",
              "--num_upsampling_layers", "normal", "--load_size", str(W), "--crop_size", str(W),
              "--aspect_ratio", "2", "--ndf", "4", "--n_layers_D", "3", "--batch_size", "2",
              "--eval_batch_size", "2", "--num_threads", "2", "--print_freq", "1", "--nepochs",
              "1", "--nepochs_decay", "0", "--save_epoch_freq", "1", "--serial_batches",
              "--contain_dontcare_label", "--init_type", "xavier", "--lr_policy", "step",
              "--lr_decay_iters", "100"]


@pytest.fixture(scope="module")
def spade_world(tmp_path_factory):
    """Cityscapes-layout data (4 train, 2 val, 128 x 64), trainId maps at
    the judge's 64 x 32 under a cityscapes-origin tree with the table that
    pairs them, a tiny JAX-written DRN judge and seeded VGG weights."""
    from cat_tpu.metrics import drn as jdrn

    root = tmp_path_factory.mktemp("spade")
    data = write_cityscapes(str(root / "cityscapes"), size=(128, 64))
    origin = root / "cityscapes-origin"
    rows, rs = [], np.random.RandomState(1)
    for i in range(2):
        stem = f"synth_{i:06d}_000019"
        rel = f"gtFine/val/synth/{stem}_gtFine_trainIds.png"
        os.makedirs(origin / "gtFine" / "val" / "synth", exist_ok=True)
        Image.fromarray(rs.randint(0, 4, (H, W)).astype(np.uint8)).save(origin / rel)
        rows.append(f"{stem} {rel} leftImg8bit/val/synth/{stem}_leftImg8bit.png")
    (root / "table.txt").write_text("\n".join(rows) + "\n")
    model = jdrn.DRNSeg(classes=4, layers=(1,) * 8, channels=(4, 8, 8, 8, 8, 8, 8, 8))
    drn_path = jdrn.save_drnseg(str(root / "drn.msgpack"), model,
                                fast_init(model, jnp.zeros((1, H, W, 3)), seed=5))
    vgg = str(root / "vgg19.pth")
    torch.save(tvgg.random_vgg19_state_dict(seed=2), vgg)
    return {"root": root, "data": data, "flags": [
        "--dataroot", data, "--vgg_path", vgg, "--drn_path", drn_path,
        "--table_path", str(root / "table.txt"), "--cityscapes_path", str(origin),
        "--inception_path", str(root / "absent.pth"), "--direction", "BtoA", *SPADE_TINY]}


def _spade_train(world, log_dir, *extra):
    return entry.train_main([*world["flags"], "--log_dir", str(log_dir), *extra], device="cpu")


def test_train_verb_spade_checkpoints_miou_and_exact_resume(spade_world, tmp_path):
    """``train --model spade --dataset_mode cityscapes``: 2 epochs of 2 steps
    write G, D (spectral vectors included) and the state with their configs,
    log mIoU at the trainer's cadence and tag the best; the saved G reloads
    to the task's eval output; resuming from the state saved after epoch 1
    equals the uninterrupted run exactly."""
    import json

    full = _spade_train(spade_world, tmp_path / "full", "--nepochs", "2")
    assert full.state.step == 4
    save_dir = tmp_path / "full" / "checkpoints"
    names = set(os.listdir(save_dir))
    assert {f"latest_net_{n}.{e}" for n in "GD" for e in ("pth", "json")} | \
        {"latest_state.pth", "best_net_G.pth"} <= names
    d_sd, d_cfg = ckpt.load_net(str(save_dir), "latest", "D")
    assert d_cfg.num_D == 2 and any(k.endswith("weight_u") for k in d_sd)
    with open(tmp_path / "full" / "scalars.jsonl") as f:
        mious = [r["metric/mIoU"] for r in map(json.loads, f) if "metric/mIoU" in r]
    assert len(mious) == 3 and all(0.0 <= v <= 100.0 for v in mious)
    assert os.path.isdir(tmp_path / "full" / "eval") is False  # no FID: no dumps
    g_sd, g_cfg = ckpt.load_net(str(save_dir), "latest", "G")
    gen = tspade.SPADEGenerator(g_cfg)
    gen.load_state_dict(g_sd)
    batch = next(iter(full.loader))
    with torch.no_grad():
        assert torch.equal(gen(full.task.semantics(batch)),
                           full.task.generate_raw(full.state, batch))

    _spade_train(spade_world, tmp_path / "half", "--nepochs", "1")
    resumed = _spade_train(spade_world, tmp_path / "resumed", "--nepochs", "1", "--epoch_base",
                           "2", "--iter_base", "3", "--restore_state_path",
                           str(tmp_path / "half" / "checkpoints" / "latest_state.pth"),
                           "--restore_G_path", str(save_dir / "latest_net_G.pth"))
    assert resumed.state.step == 4
    a, b = (ckpt.load_train_state(str(tmp_path / d / "checkpoints"), "latest")
            for d in ("full", "resumed"))
    for net in ("g", "d"):
        for part in ("params", "stats"):
            assert a[net][part].keys() == b[net][part].keys()
            assert all(torch.equal(v, b[net][part][k]) for k, v in a[net][part].items())
        assert all(torch.equal(v, b[net]["opt"]["mu"][k]) for k, v in a[net]["opt"]["mu"].items())


def test_train_verb_spade_evaluates_fid_and_miou(spade_world, tmp_path):
    """With a judge and real statistics as well, the evaluation the verb
    builds reports FID and mIoU and flags the best, dumping the label maps
    and fakes; without the VGG weights it warns and trains without the
    perceptual loss."""
    from cat_tpu_torch import cli
    from cat_tpu_torch.metrics.inception import write_random_judge

    judge = write_random_judge(str(tmp_path / "judge.pth"), seed=1)
    stats = str(tmp_path / "stats.npz")
    entry.real_stat_main(["--dataroot", os.path.join(spade_world["data"], "leftImg8bit", "val"),
                          "--inception_path", judge, "--output_path", stats, "--load_size",
                          "36", "--crop_size", "32"], device="cpu")
    parser = cli.train_parser()
    opt = parser.parse_args([*spade_world["flags"], "--log_dir", str(tmp_path / "log"),
                             "--inception_path", judge, "--real_stat_path", stats,
                             "--vgg_path", str(tmp_path / "absent.pth")])
    run = entry.setup_train(opt, "cpu")
    try:
        assert run.task.vgg is None
        metrics, flags = run.trainer.evaluate_fn(run.state, 1)
    finally:
        run.close()
    assert {"metric/fid", "metric/mIoU"} <= set(metrics) and flags == {"is_best": True}
    assert np.isfinite(metrics["metric/fid"])
    dump = tmp_path / "log" / "eval" / "1"
    assert sorted(os.listdir(dump / "input")) == sorted(os.listdir(dump / "fake"))
    assert len(os.listdir(dump / "fake")) == 2


# ---------------------------------------------------------------------------
# The generic SPADE datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("load_in_memory", [False, True])
def test_template_dataset_items_match_jax(tmp_path, load_in_memory):
    """``TemplateDataset`` against the JAX package's on the same folder and
    seed: the same label (255 remapped to input_nc), instance and image
    (CHW here) at every access, the random crop redrawn at every access
    with the cache too; the cache holds the decoded images."""
    from cat_tpu.data import spade_generic as jgen
    from cat_tpu.data.transforms import TransformSpec as JSpec
    from cat_tpu_torch.data import spade_generic as tgen
    from tests.test_html_and_spade_generic import _make_spade_root

    root = _make_spade_root(tmp_path)
    kw = dict(preprocess="resize_and_crop", load_size=16, crop_size=8, no_flip=False)
    want = jgen.TemplateDataset(root, "train", spec=JSpec(**kw), input_nc=5, seed=0,
                                load_in_memory=load_in_memory)
    got = tgen.TemplateDataset(root, "train", spec=TransformSpec(**kw), input_nc=5, seed=0,
                               load_in_memory=load_in_memory)
    assert len(got) == len(want) == 3
    crops = set()
    for i in (0, 1, 2, 0, 0, 1):
        g, w = got[i], want[i]
        assert g.keys() == w.keys() and g["path"] == w["path"]
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["instance"], w["instance"])
        np.testing.assert_array_equal(g["image"], w["image"].transpose(2, 0, 1))
        assert g["label"].dtype == np.float32 and g["instance"].dtype == np.int32
        assert g["image"].shape == (3, 8, 8) and g["label"].max() <= 5.0
        crops.add(tuple(g["label"].ravel()))
    assert len(crops) > 3, "random crop frozen"
    if load_in_memory:
        os.remove(os.path.join(root, "train_images", "s1.png"))
        assert got[1]["image"].shape == (3, 8, 8)


def test_spade_generic_checks_and_alignment_match_jax(tmp_path):
    """The pairing check, ``no_instance``/``max_size``, the abstract base,
    and the label and image sharing one crop and flip."""
    from cat_tpu_torch.data import spade_generic as tgen
    from tests.test_html_and_spade_generic import _make_spade_root

    spec = TransformSpec(preprocess="resize_and_crop", load_size=16, crop_size=8, no_flip=True)
    root = _make_spade_root(tmp_path / "a", mismatch=True, instances=False)
    with pytest.raises(AssertionError):
        tgen.TemplateDataset(root, "train", spec=spec, no_instance=True)
    with pytest.raises(ValueError, match="instance maps"):
        tgen.TemplateDataset(root, "train", spec=spec, pairing_check=False)
    ds = tgen.TemplateDataset(root, "train", spec=spec, no_instance=True, pairing_check=False,
                              max_size=2)
    assert len(ds) == 2 and "instance" not in ds[0]
    with pytest.raises(NotImplementedError):
        tgen.SPADEDataset(str(tmp_path))

    # the column index in label and image: any divergence of the two crops shows
    root = tmp_path / "b"
    (root / "train_labels").mkdir(parents=True)
    (root / "train_images").mkdir(parents=True)
    col = np.tile(np.arange(32, dtype=np.uint8), (32, 1))
    Image.fromarray(col, "L").save(root / "train_labels" / "a.png")
    Image.fromarray(np.stack([col] * 3, -1)).save(root / "train_images" / "a.png")
    ds = tgen.TemplateDataset(str(root), "train", no_instance=True, seed=3,
                              spec=TransformSpec(preprocess="resize_and_crop", load_size=32,
                                                 crop_size=16, no_flip=False))
    for _ in range(4):
        item = ds[0]
        np.testing.assert_allclose((item["image"][0, 0] + 1.0) * 127.5, item["label"][0],
                                   atol=0.75)
