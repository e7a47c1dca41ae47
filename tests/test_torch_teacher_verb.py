"""The port's CycleGAN task against the JAX package's, and the train verb
end to end on the CPU (crop 32, ngf 4-8, 3 blocks, 4 images per side): its
flag surface, its checkpoints, an exact resume, and weights both ways with
the JAX package (a ``.msgpack`` teacher and D from its train verb into the
port's distill verb; a port ``.pth`` generator with running statistics back
through ``cat_tpu/utils/torch_import.py``)."""

import argparse
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import cat_tpu.cli as jcli
import cat_tpu.train.cyclegan as jcyclegan
from cat_tpu.core import config as jcfg
from cat_tpu.models.generator import InceptionGenerator as JGen
from cat_tpu.utils import checkpoint as jckpt
from cat_tpu.utils.torch_import import import_inception_generator
from cat_tpu_torch import cli, entry
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.ops.nn import frozen_stats
from cat_tpu_torch.train.common import load_train_state_dict
from cat_tpu_torch.train.cyclegan import CycleGANHParams, CycleGANTask
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from tests.test_torch_teacher import (LR, SIZE, _close, _params_close, jax_stats_left_alone,
                                      nchw, nhwc, state_names, to_port)
from tests.test_torch_verb import _surface, opt_names

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# CycleGANTask
# ---------------------------------------------------------------------------


def test_cyclegan_task_matches_jax(rng, tmp_path):
    """Losses after 1 and 3 steps at rtol 1e-4, parameters within
    2.5·lr·steps, and the pools (batch 2 into a pool of 50: filling, so the
    same images) within float32 noise of the JAX package's; the JAX task's
    saved state restores into the port exactly."""
    gcfg = jcfg.InceptionGeneratorConfig.make(ngf=4, channels_reduction_factor=2,
                                              kernel_sizes=(1, 3, 5), n_blocks=3)
    dcfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8,
                                          norm=jcfg.NormConfig(kind="instance", affine=True))
    jtask = jcyclegan.CycleGANTask(gcfg, dcfg, jcyclegan.CycleGANHParams())
    jstate = jtask.init_state(jax.random.PRNGKey(0), SIZE, SIZE)
    task = CycleGANTask(to_port(gcfg), to_port(dcfg), CycleGANHParams(), device="cpu")
    state = task.init_state(SIZE, SIZE)
    for n in "AB":
        task.netG[n].load_state_dict(jax_import.generator_state_dict(jstate.g.params[n], gcfg))
        task.netD[n].load_state_dict(jax_import.nlayer_discriminator_state_dict(
            jstate.d.params[n], dcfg))
    batch = {k: rng.randn(2, SIZE, SIZE, 3).astype(np.float32) for k in "AB"}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: nchw(v) for k, v in batch.items()}
    for step in (1, 2, 3):
        jstate, jm = jtask.train_step(jstate, jbatch, LR)
        state, tm = task.train_step(state, tbatch, LR)
        if step == 2:
            continue
        assert list(tm) == ["G_loss/idt_A", "G_loss/idt_B", "G_loss/gan_A", "G_loss/gan_B",
                            "G_loss/cycle_A", "G_loss/cycle_B", "D_loss/A", "D_loss/B"]
        assert tm.keys() == jm.keys()
        for k in jm:
            _close(float(tm[k]), float(jm[k]), f"step {step} {k}", rtol=1e-4, atol=1e-6)
        for kind, ref_of, nets in (
                ("G", lambda n: jax_import.generator_state_dict(jstate.g.params[n], gcfg),
                 task.netG),
                ("D", lambda n: jax_import.nlayer_discriminator_state_dict(
                    jstate.d.params[n], dcfg), task.netD)):
            for n in "AB":
                got, ref = nets[n].state_dict(), ref_of(n)
                _params_close(got, {k: ref[k] for k in got}, step, f"{kind}_{n}")
        for name, pool in state.pools.items():
            jpool = getattr(jstate.extra, name)
            assert pool.count == int(jpool.count) == 2 * step
            _close(nhwc(pool.buffer[:pool.count]), np.asarray(jpool.buffer)[:pool.count],
                   name, rtol=1e-3, atol=1e-3)
    for d in ("AtoB", "BtoA"):
        _close(nhwc(task.generate(state, tbatch["A"], d)),
               jtask.generate(jstate, jbatch["A"], d), d, rtol=1e-3, atol=1e-3)

    # the JAX task's <tag>_state.msgpack restores into a fresh port state
    path = jckpt.save_train_state(str(tmp_path), "latest", jstate)
    fresh = CycleGANTask(to_port(gcfg), to_port(dcfg), CycleGANHParams(), device="cpu")
    restored = load_train_state_dict(fresh.init_state(SIZE, SIZE), jax_import.train_state_dict(
        ckpt.load_pytree(path), "cycle_gan", to_port(gcfg), to_port(dcfg)))
    assert restored.step == 3 and restored.g.opt.count == restored.d.opt.count == 3
    for n in "AB":
        want = jax_import.generator_state_dict(jstate.g.params[n], gcfg)
        assert all(torch.equal(v, want[k]) for k, v in fresh.netG[n].state_dict().items())
        want = jax_import.generator_state_dict(jstate.g.opt_state.mu[n], gcfg)
        assert all(torch.equal(restored.g.opt.mu[i], want[k[2:]]) for i, k in
                   enumerate(restored.g.params) if k.startswith(f"{n}."))
    for name, pool in restored.pools.items():
        jpool = getattr(jstate.extra, name)
        assert pool.count == int(jpool.count)
        np.testing.assert_array_equal(nhwc(pool.buffer), np.asarray(jpool.buffer))


def test_cyclegan_keeps_generator_statistics_and_moves_the_discriminators(rng):
    """Tracked batch norm: G's running statistics never change in training
    (no G forward of the JAX task is mutable); each D's move twice a step,
    on the real then the pooled fake."""
    norm = jcfg.NormConfig(kind="batch", affine=True, track_running_stats=True)
    gcfg = jcfg.InceptionGeneratorConfig.make(ngf=4, channels_reduction_factor=2,
                                              kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm)
    dcfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8, norm=norm)
    task = CycleGANTask(to_port(gcfg), to_port(dcfg), CycleGANHParams(pool_size=0),
                        device="cpu")
    state = task.init_state(SIZE, SIZE)
    g0 = {k: v.clone() for k, v in state.g.stats.items()}
    d0 = {n: copy.deepcopy(task.netD[n]) for n in "AB"}
    a, b = (torch.from_numpy(rng.randn(2, 3, SIZE, SIZE).astype(np.float32)) for _ in "AB")
    with torch.no_grad(), frozen_stats(task.netG):
        fake_b, fake_a = task.netG["A"](a, train=True), task.netG["B"](b, train=True)
    task.train_step(state, {"A": a, "B": b}, LR)
    assert all(torch.equal(state.g.stats[k], v) for k, v in g0.items())
    with torch.no_grad():
        for n, real, fake in (("A", b, fake_b), ("B", a, fake_a)):
            d0[n](real, train=True)
            d0[n](fake, train=True)
            for k, v in d0[n].named_buffers():
                torch.testing.assert_close(state.d.stats[f"{n}.{k}"], v, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The train verb
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Unaligned (trainA/B, valA/B) and aligned (train/val, A|B side by side)
    seeded PNGs."""
    root = tmp_path_factory.mktemp("teacher")
    rs = np.random.RandomState(0)
    for side in ("trainA", "trainB", "valA", "valB"):
        os.makedirs(root / "unaligned" / side)
        for i in range(4):
            Image.fromarray(rs.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                root / "unaligned" / side / f"{i}.png")
    for split in ("train", "val"):
        os.makedirs(root / "aligned" / split)
        for i in range(4):
            Image.fromarray(rs.randint(0, 256, (40, 80, 3), dtype=np.uint8)).save(
                root / "aligned" / split / f"{i}.png")
    return root


TINY = ["--ngf", "4", "--ndf", "8", "--channels_reduction_factor", "2", "--kernel_sizes", "1",
        "3", "5", "--n_blocks", "3", "--batch_size", "2", "--load_size", "36", "--crop_size",
        str(SIZE), "--num_threads", "2", "--print_freq", "1", "--nepochs", "2",
        "--nepochs_decay", "0", "--save_epoch_freq", "2", "--serial_batches", "--no_flip",
        "--lr_policy", "step", "--lr_decay_iters", "100"]
# the flags of scripts/cycle_gan/horse2zebra/train_inception_teacher.sh and
# scripts/pix2pix/map2sat/train_inception_teacher.sh, cut to this size
RECIPES = {
    "cycle_gan": ["--model", "cycle_gan", "--norm_affine", "--norm_affine_D"],
    "pix2pix": ["--model", "pix2pix", "--lambda_recon", "10", "--norm", "batch", "--norm_affine",
                "--norm_affine_D", "--norm_track_running_stats", "--direction", "BtoA"],
}


def _train(data, model, log_dir, *extra):
    root = data / ("unaligned" if model == "cycle_gan" else "aligned")
    return entry.train_main(["--dataroot", str(root), "--log_dir", str(log_dir), *RECIPES[model],
                             *TINY, *extra], device="cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("model", ["cycle_gan", "pix2pix"])
def test_train_verb_checkpoints_and_exact_resume(data, tmp_path, model):
    """2 epochs of 2 steps write the named checkpoints with their configs
    and running statistics; the saved G reloads to the in-memory G's output;
    resuming from the state saved after epoch 1 equals the uninterrupted run
    exactly (weights, statistics, moments, pools, step)."""
    same = ("--load_size", str(SIZE))  # no random crops: both runs see the same batches
    full = _train(data, model, tmp_path / "full", *same)
    nets = ["G_A", "G_B", "D_A", "D_B"] if model == "cycle_gan" else ["G", "D"]
    names = set(os.listdir(tmp_path / "full" / "checkpoints"))
    for tag in ("latest", "2"):
        assert {f"{tag}_net_{n}.{e}" for n in nets for e in ("pth", "json")} | \
            {f"{tag}_state.pth"} <= names
    assert full.state.step == 4
    if model == "cycle_gan":
        assert {p.count for p in full.state.pools.values()} == {8}
    else:
        sd, _ = ckpt.load_net(str(tmp_path / "full" / "checkpoints"), "latest", "D")
        assert any(k.endswith("running_var") for k in sd)
    g_name = nets[0]
    sd, cfg = ckpt.load_net(str(tmp_path / "full" / "checkpoints"), "latest", g_name)
    gen = InceptionGenerator(cfg, packed_blocks=True)
    gen.load_state_dict(sd)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, SIZE, SIZE).astype(np.float32))
    with torch.no_grad():
        want = full.task.generate(full.state, x) if model == "pix2pix" else \
            full.task.generate(full.state, x, "AtoB")
        assert torch.equal(gen(x), want)

    _train(data, model, tmp_path / "half", *same, "--nepochs", "1")
    resumed = _train(data, model, tmp_path / "resumed", *same, "--nepochs", "1", "--epoch_base",
                     "2",
                     "--iter_base", "3", "--restore_state_path",
                     str(tmp_path / "half" / "checkpoints" / "latest_state.pth"))
    assert resumed.state.step == 4
    a, b = (dict(_leaves(ckpt.load_train_state(str(tmp_path / d / "checkpoints"), "latest")))
            for d in ("full", "resumed"))
    assert a.keys() == b.keys()
    for k in a:
        same = torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
        assert same, k


def test_train_verb_needs_cuda_unless_cpu_is_asked_for(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.train_main(["--dataroot", str(data / "aligned"), "--log_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "opt.txt")


@pytest.mark.parametrize("flags,match", [
    # a pix2pix teacher cannot read the SPADE family's data: the JAX package's
    # generic loader has no cityscapes mode
    (["--dataset_mode", "cityscapes"], r"dataset mode \[cityscapes\] not implemented"),
    (["--netD", "pixel"], "build only the n_layers discriminator"),
])
def test_train_verb_refuses_what_is_not_ported(data, tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        _train(data, "pix2pix", tmp_path, *flags)


def _jax_train_parser():
    p = argparse.ArgumentParser()
    jcli.base_arguments(p)
    jcli.train_arguments(p)
    jcli.spade_arguments(p)
    return p


def test_train_flag_surface_equals_the_jax_train_parser():
    assert _surface(cli.train_parser()) == _surface(_jax_train_parser())


# flags the JAX package's train verb accepts and does not read
TRAIN_INERT = {
    "netG", "restore_D_path",
    # the distill step's teacher dtype and student EMA
    "teacher_compute_dtype", "moving_average_decay", "moving_average_decay_adjust",
    "moving_average_decay_base_batch",
    # the SPADE distiller's
    "remat_policy", "teacher_norm_G", "student_norm_G",
}
# the distill, profile and other verbs' code, which the train verb never runs
OTHER_VERBS = {"setup_distill", "setup_distill_inception", "distill_main", "shrink_preamble",
               "profile_distill", "profile_main", "_profile_eval_sweep", "_generator_fn",
               "real_stat_main", "kid_score_main", "_ema_decay", "setup_distill_spade",
               "load_spade_checkpoint", "profile_distill_spade", "_spade_bounds"}


def test_every_train_flag_consumed_raised_or_documented_inert():
    flags = set(_surface(cli.train_parser()))
    assert not sorted(flags - opt_names() - TRAIN_INERT)
    assert not sorted(TRAIN_INERT & opt_names(OTHER_VERBS))


# ---------------------------------------------------------------------------
# Weights both ways
# ---------------------------------------------------------------------------


def test_jax_train_verb_checkpoints_feed_the_port_distill_verb(data, tmp_path, monkeypatch):
    """The JAX package's train verb writes a pix2pix teacher with tracked
    batch norm (.msgpack + .json, G with its statistics, D with its
    statistics beside the parameters); the port's distill verb restores both
    (--restore_teacher_G_path, --restore_D_path) exactly and trains on
    them."""
    from cat_tpu.entry import train_main as jax_train_main

    jax_stats_left_alone(monkeypatch)
    jlog = tmp_path / "jax"
    jax_train_main(["--dataroot", str(data / "aligned"), "--log_dir", str(jlog),
                    *RECIPES["pix2pix"], *TINY, "--nepochs", "1"])
    jdir = jlog / "checkpoints"
    g_path, d_path = str(jdir / "latest_net_G.msgpack"), str(jdir / "latest_net_D.msgpack")
    distill = ["--dataroot", str(data / "aligned"), "--restore_teacher_G_path", g_path,
               "--restore_D_path", d_path, "--norm", "batch", "--norm_affine", "--norm_affine_D",
               "--norm_track_running_stats", "--direction", "BtoA", "--ndf", "8",
               "--student_ngf", "4", "--channels_reduction_factor", "2", "--kernel_sizes", "1",
               "3", "5", "--n_blocks", "3", "--distill_G_loss_type", "ka", "--batch_size", "2",
               "--load_size", "36", "--crop_size", str(SIZE), "--num_threads", "2",
               "--nepochs", "1", "--nepochs_decay", "0", "--print_freq", "1"]
    probe = entry.distill_main([*distill, "--log_dir", str(tmp_path / "probe"), "--prune_only"],
                               device="cpu")
    jg = ckpt.load_pytree(g_path)
    gcfg = jcfg.config_from_json(open(g_path[:-len(".msgpack")] + ".json").read())
    x = np.random.RandomState(2).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = JGen(gcfg).apply({"params": jg["params"], "batch_stats": jg["batch_stats"]},
                            jnp.asarray(x), train=False)
    with torch.no_grad():
        got = probe.distiller.generate_teacher(probe.teacher_params, nchw(x))
    _close(nhwc(got), want, "teacher", rtol=1e-4, atol=1e-5)
    jd = ckpt.load_pytree(d_path)
    d_sd = probe.distiller.netD.state_dict()
    want_d = jax_import.discriminator_net_state_dict(jd, probe.distiller.disc_cfg)
    assert d_sd.keys() == want_d.keys() and any("running" in k for k in d_sd)
    assert all(torch.equal(d_sd[k], want_d[k]) for k in d_sd)
    run = entry.distill_main([*distill, "--log_dir", str(tmp_path / "run")], device="cpu")
    assert run.state.step == 2 and run.state.g.stats

    # its full state resumes the port's train verb: weights, statistics, moments, step
    parser = cli.train_parser()
    opt = parser.parse_args(["--dataroot", str(data / "aligned"), "--log_dir",
                             str(tmp_path / "resume"), *RECIPES["pix2pix"], *TINY,
                             "--restore_state_path", str(jdir / "latest_state.msgpack")])
    resumed = entry.setup_train(opt, "cpu")
    resumed.close()
    jstate = ckpt.load_pytree(str(jdir / "latest_state.msgpack"))
    assert resumed.state.step == 2 and resumed.state.d.opt.count == 2
    for net, ns, want in (
            (resumed.task.netG, jstate["g"], jax_import.generator_state_dict(
                jstate["g"]["params"], gcfg, jstate["g"]["stats"])),
            (resumed.task.netD, jstate["d"], jax_import.nlayer_discriminator_state_dict(
                jstate["d"]["params"], resumed.disc_cfg, jstate["d"]["stats"]))):
        got = net.state_dict()
        assert got.keys() == want.keys() and any("running" in k for k in got)
        assert all(torch.equal(got[k], want[k]) for k in got)


def test_port_generator_with_running_stats_goes_back_to_jax(rng, tmp_path):
    """A port .pth generator with tracked batch norm and statistics away
    from (0, 1) gives the JAX generator's eval-mode output after
    ``import_inception_generator``."""
    norm = jcfg.NormConfig(kind="batch", affine=True, track_running_stats=True)
    gcfg = jcfg.InceptionGeneratorConfig.make(ngf=4, channels_reduction_factor=2,
                                              kernel_sizes=(1, 3, 5), n_blocks=3, norm=norm)
    gen = InceptionGenerator(to_port(gcfg), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, buf in gen.named_buffers():
            buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
    path = ckpt.save_net(str(tmp_path), "best", "G", gen.state_dict(), to_port(gcfg))
    sd = {k: v.numpy() for k, v in ckpt.load_pytree(path).items()}
    _, variables = import_inception_generator(sd, gcfg)
    assert "batch_stats" in variables
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = JGen(gcfg).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(nhwc(gen(nchw(x))), want, "eval output", rtol=1e-4, atol=1e-5)
    assert state_names(gen, True)
