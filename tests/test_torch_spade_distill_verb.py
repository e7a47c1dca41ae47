"""The SPADE distill and profile verbs of the port on the CPU at toy scale
(an ngf-4 teacher of 64 x 32 over Cityscapes-layout data, batch 2), and one
``SPADEDistiller`` step under wgangp with EMA against the JAX distiller."""

import os

import numpy as np
import pytest
import torch

from cat_tpu_torch import entry
from cat_tpu_torch.compress.spade import profile_spade_generator, shrink_spade_generator
from cat_tpu_torch.compress.transfer import transfer_spade_generator_params
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig, SPADEGeneratorConfig
from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator
from cat_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_spade import H, W, _close, spade_world  # noqa: F401
from tests.test_torch_spade_distill import (LR, _batch, _check_eval, _compare_states,
                                            _worlds)
from tests.test_torch_teacher import fixed_alpha

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def spade_teacher(spade_world):  # noqa: F811
    """A seeded teacher (ngf 4, norm scales spread so that the shrink has
    signal) and a D of the SPADE defaults' four layers beside
    ``spade_world``'s data and judges, and the student recipe's flags over
    them at half the teacher's MACs."""
    root = spade_world["root"]
    cfg = SPADEGeneratorConfig.make(semantic_nc=5, ngf=4, channels_reduction_factor=4,
                                    kernel_sizes=(1, 3), num_upsampling_layers="normal",
                                    crop_size=W, aspect_ratio=2.0)
    gen = SPADEGenerator(cfg, "xavier", generator=torch.Generator().manual_seed(3))
    rs = np.random.RandomState(3)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(torch.from_numpy(rs.uniform(0.05, 2.0, p.shape).astype(np.float32)))
    g_path = ckpt.save_net(str(root), "teacher", "G", gen.state_dict(), cfg)
    d_cfg = MultiscaleDiscriminatorConfig(input_nc=8, ndf=4, n_layers=4, num_D=2)
    d_path = ckpt.save_net(str(root), "teacher", "D", MultiscaleDiscriminator(
        d_cfg, "xavier", generator=torch.Generator().manual_seed(4)).state_dict(), d_cfg)
    target = 0.5 * profile_spade_generator(cfg, H, W).macs
    flags = [*spade_world["flags"], "--distiller", "spade", "--restore_teacher_G_path", g_path,
             "--restore_pretrained_G_path", g_path, "--restore_D_path", d_path,
             "--target_flops", str(target), "--distill_G_loss_type", "ka",
             "--lambda_distill", "0.5"]
    return {"cfg": cfg, "sd": gen.state_dict(), "d_sd": ckpt.load_pytree(d_path),
            "target": target, "flags": flags, "world": spade_world}


def spade_distill_run(teacher, log_dir, *extra):
    """``distill --distiller spade`` over ``spade_teacher``'s flags; the Gram
    calls counted."""
    calls = []
    gram = tka.gram
    tka.gram = lambda x: calls.append(tuple(x.shape)) or gram(x)
    try:
        run = entry.distill_main([*teacher["flags"], "--log_dir", str(log_dir), *extra],
                                 device="cpu")
    finally:
        tka.gram = gram
    return run, calls


def check_spade_distill_run(teacher, log_dir, run, calls):
    """One epoch of 2 KA steps: 6 Gram calls a step; the student config the
    shrink gives; G and the state written with their configs, no G_raw
    without EMA; mIoU at the trainer's cadence; the reloaded G gives the
    distiller's eval output exactly."""
    import json

    assert run.state.step == 2 and len(calls) == 12
    assert {c[0] for c in calls} == {2}
    res = shrink_spade_generator(teacher["cfg"], teacher["sd"], teacher["target"], H, W)
    with open(os.path.join(log_dir, "student_config.json")) as f:
        assert f.read() == tcfg.config_to_json(res.config)
    save_dir = os.path.join(log_dir, "checkpoints")
    names = set(os.listdir(save_dir))
    assert {"latest_net_G.pth", "latest_net_G.json", "latest_state.pth"} <= names
    assert not any(n.startswith("latest_net_G_raw") for n in names)
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        rows = list(map(json.loads, f))
    mious = [r["metric/mIoU"] for r in rows if "metric/mIoU" in r]
    assert len(mious) == 2 and all(0.0 <= v <= 100.0 for v in mious)
    assert all(np.isfinite(r[k]) for r in rows for k in r if "distill" in k)
    sd, cfg = ckpt.load_net(save_dir, "latest", "G")
    gen = SPADEGenerator(cfg)
    gen.load_state_dict(sd)
    batch = next(iter(run.loader))
    with torch.no_grad():
        assert torch.equal(gen(run.distiller.semantics(batch)),
                           run.distiller.generate_student_raw(run.state, batch))
    return save_dir


def test_distill_verb_spade_warm_starts_as_the_recipe_says(spade_teacher, tmp_path):
    """--prune_only: the student config is the shrink's and is written; the
    student's parameters are the transfer's from the pretrained G (its
    statistics fresh); D is the teacher's with its spectral ``u``; the
    adaptors sit in the G group; nothing trains."""
    run = entry.distill_main([*spade_teacher["flags"], "--log_dir", str(tmp_path),
                              "--prune_only"], device="cpu")
    assert run.trainer is None and run.state.step == 0
    dist = run.distiller
    res = shrink_spade_generator(spade_teacher["cfg"], spade_teacher["sd"],
                                 spade_teacher["target"], H, W)
    assert dist.student_cfg == res.config and res.searched_macs <= spade_teacher["target"]
    want = transfer_spade_generator_params(spade_teacher["sd"], spade_teacher["cfg"],
                                           res.config)
    assert want.keys() == run.state.g.params.keys()
    assert all(torch.equal(v, want[k]) for k, v in run.state.g.params.items())
    assert all(torch.equal(v, torch.zeros_like(v)) for k, v in run.state.g.stats.items()
               if k.endswith("running_mean"))
    d_sd = dist.netD.state_dict()
    assert all(torch.equal(v, d_sd[k]) for k, v in spade_teacher["d_sd"].items())
    assert sorted(run.state.adaptors) == [f"A{i}.{p}" for i in range(3) for p in ("bias",
                                                                                  "weight")]
    assert len(run.state.g.opt.params) == len(want) + 6
    assert os.path.exists(tmp_path / "student_config.json")


def test_distill_verb_spade_trains_evaluates_and_saves(spade_teacher, tmp_path):
    run, calls = spade_distill_run(spade_teacher, tmp_path)
    check_spade_distill_run(spade_teacher, str(tmp_path), run, calls)


def test_distill_verb_spade_ema_saves_raw_and_eval_weights(spade_teacher, tmp_path):
    """With --moving_average_decay, net_G holds the EMA weights and net_G_raw
    the trained ones; a resume from the state carries the EMA."""
    run, _ = spade_distill_run(spade_teacher, tmp_path, "--moving_average_decay", "0.9",
                               "--nepochs", "1")
    save_dir = str(tmp_path / "checkpoints")
    g, _ = ckpt.load_net(save_dir, "latest", "G")
    raw, _ = ckpt.load_net(save_dir, "latest", "G_raw")
    for k, v in run.state.extra["ema_G"].items():
        assert torch.equal(g[k], v) and torch.equal(raw[k], run.state.g.params[k].detach())
    assert any(not torch.equal(g[k], raw[k]) for k in run.state.extra["ema_G"])
    resumed = entry.distill_main([*spade_teacher["flags"], "--log_dir", str(tmp_path / "r"),
                                  "--moving_average_decay", "0.9", "--prune_only",
                                  "--restore_state_path",
                                  os.path.join(save_dir, "latest_state.pth")], device="cpu")
    assert resumed.state.step == 2
    assert all(torch.equal(v, run.state.extra["ema_G"][k])
               for k, v in resumed.state.extra["ema_G"].items())


def test_profile_verb_spade_times_counts_and_evaluates(spade_teacher, tmp_path):
    """``profile --distiller spade`` on a trained student's checkpoint, with
    the FID judge and real statistics: the student's analytic MACs, a
    latency, FID and mIoU, the student's and the teacher's images dumped;
    without --pretrained_student_G_path it profiles the shrink's student."""
    from cat_tpu_torch.metrics.inception import write_random_judge

    run, _ = spade_distill_run(spade_teacher, tmp_path / "distill", "--nepochs", "1")
    judge = write_random_judge(str(tmp_path / "judge.pth"), seed=1)
    stats = str(tmp_path / "stats.npz")
    data = spade_teacher["world"]["data"]
    entry.real_stat_main(["--dataroot", os.path.join(data, "leftImg8bit", "val"),
                          "--inception_path", judge, "--output_path", stats, "--load_size",
                          "36", "--crop_size", "32"], device="cpu")
    out = entry.profile_main([*spade_teacher["flags"], "--log_dir", str(tmp_path / "prof"),
                              "--pretrained_student_G_path",
                              str(tmp_path / "distill" / "checkpoints" / "latest_net_G.pth"),
                              "--inception_path", judge, "--real_stat_path", stats,
                              "--times", "2"], device="cpu")
    assert out["student_macs"] == profile_spade_generator(run.student_cfg, H, W).macs
    assert out["latency_ms"] > 0 and out["pruning_seconds_mean"] > 0
    assert np.isfinite(out["metrics"]["metric/fid"])
    assert 0.0 <= out["metrics"]["metric/mIoU"] <= 100.0
    dump = tmp_path / "prof" / "eval" / "latest"
    assert len(os.listdir(dump / "Sfake")) == len(os.listdir(dump / "Tfake")) == 2
    shrunk = entry.profile_main([*spade_teacher["flags"], "--log_dir", str(tmp_path / "p2"),
                                 "--no_mIoU", "--times", "1"], device="cpu")
    assert shrunk["student_config"] == run.student_cfg
    assert shrunk["metrics"] == {}


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_distill_verb_spade_int8_teacher(spade_teacher, tmp_path, mode):
    """The int8 teacher (refused until the int8 convolutions were ported,
    ``ops/quant.py``) runs through the verb: the run checks of
    ``check_spade_distill_run`` hold, the losses are the float teacher's
    run's keys, finite, step 1's distill loss within 2% of the float run's
    and not equal to it; int8_static keeps the scales of one calibration."""
    ref_run, _ = spade_distill_run(spade_teacher, tmp_path / "float", "--nepochs", "1")
    run, calls = spade_distill_run(spade_teacher, tmp_path / mode, "--nepochs", "1",
                                   "--teacher_compute_dtype", mode)
    check_spade_distill_run(spade_teacher, str(tmp_path / mode), run, calls)
    ref, got = _scalars(tmp_path / "float"), _scalars(tmp_path / mode)
    assert [r.keys() for r in got] == [r.keys() for r in ref]
    assert all(np.isfinite(v) for r in got for v in r.values())
    np.testing.assert_allclose(got[0]["G_loss/distill"], ref[0]["G_loss/distill"], rtol=2e-2)
    assert got[0]["G_loss/distill"] != ref[0]["G_loss/distill"]
    assert (run.distiller._act_scales is None) == (mode == "int8")


def _scalars(log_dir):
    import json

    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [{k: v for k, v in r.items() if "loss" in k} for r in map(json.loads, f)]


@pytest.mark.parametrize("remat", ["0", "1"])
def test_distill_verb_spade_remat_policy(spade_teacher, tmp_path, remat):
    """--remat_policy dots_saveable: ignored without --remat, as in the JAX
    package (the run is the plain run, bit for bit); under --remat 1 the
    selective recompute gives the plain run's losses and student.  An
    unsupported name fails under --remat 1 before any checkpoint is read."""
    plain, _ = spade_distill_run(spade_teacher, tmp_path / "plain", "--nepochs", "1")
    run, calls = spade_distill_run(spade_teacher, tmp_path / "policy", "--nepochs", "1",
                                   "--remat", remat, "--remat_policy", "dots_saveable")
    assert run.distiller.hp.remat_policy == "dots_saveable" and len(calls) == 12
    assert run.distiller.policy is None if remat == "0" else callable(run.distiller.policy)
    got, want = _scalars(tmp_path / "policy"), _scalars(tmp_path / "plain")
    assert [r.keys() for r in got] == [r.keys() for r in want]
    exact = remat == "0"
    for g, w in zip(got, want):
        for k in w:
            _close(g[k], w[k], k, rtol=0 if exact else 1e-5, atol=0 if exact else 1e-7)
    for k, v in run.state.g.params.items():
        _close(v.detach(), plain.state.g.params[k].detach(), k, rtol=0 if exact else 1e-5,
               atol=0 if exact else 1e-6)
    flags = list(spade_teacher["flags"])
    flags[flags.index("--restore_teacher_G_path") + 1] = str(tmp_path / "absent.pth")
    with pytest.raises(ValueError, match="dots_saveable"):
        entry.distill_main([*flags, "--log_dir", str(tmp_path / "bad"), "--remat", "1",
                            "--remat_policy", "save_only_these_names"], device="cpu")


def test_spade_distiller_wgangp_and_ema_match_jax(rng, tmp_path, monkeypatch):
    """One step under wgangp (the penalty's α fixed on both sides) with EMA:
    losses, parameters, statistics, ``u`` and the EMA weights against the
    JAX distiller's; evaluation reads the EMA weights."""
    fixed_alpha(monkeypatch)
    jdist, jstate, tv, dist, state, tparams = _worlds(
        tmp_path, gan_mode="wgangp", ema_decay=0.9, lambda_vgg=0.0)
    jbatch, tbatch = _batch(rng)
    jstate, jm = jdist.train_step(jstate, tv, jbatch, LR)
    state, tm = dist.train_step(state, tparams, tbatch, LR)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), k, rtol=1e-4, atol=1e-6)
    want, got = _compare_states(jstate, state, dist, tmp_path, 1)
    assert got["extra"]["ema_G"].keys() == want["extra"]["ema_G"].keys()
    # the EMA moves a tenth of the parameters' step
    worst = max(float((v.detach() - want["extra"]["ema_G"][k]).abs().max())
                for k, v in got["extra"]["ema_G"].items())
    assert worst <= 0.1 * 2.5 * LR / 2, worst
    assert dist.student_eval_params(state) is state.extra["ema_G"]
    _check_eval(jdist, jstate, dist, state, jbatch, tbatch, tmp_path)
