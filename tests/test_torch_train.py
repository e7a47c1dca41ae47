"""The port's optimiser, configs, shrink and KA-distillation step against
the JAX package (CPU, float32, inputs made with numpy from a seed)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.compress.shrink import PruneBounds as JBounds
from cat_tpu.compress.shrink import shrink_generator as jax_shrink
from cat_tpu.core import config as jcfg
from cat_tpu.distill.inception_distiller import DistillHParams as JHP
from cat_tpu.distill.inception_distiller import InceptionDistiller as JDistiller
from cat_tpu.train.optim import adam_tx, apply_updates
from cat_tpu.utils import checkpoint as jckpt
from cat_tpu.utils.torch_import import import_inception_generator
from cat_tpu_torch.compress.profiling import profile_generator
from cat_tpu_torch.compress.shrink import PruneBounds, shrink_generator
from cat_tpu_torch.core import config as tcfg
from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.train.common import load_train_state_dict
from cat_tpu_torch.train.optim import Adam
from cat_tpu_torch.utils import checkpoint as ckpt
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init

torch.set_num_threads(1)

SIZE = 32
LR = 2e-4


def to_port(cfg):
    return tcfg.config_from_json(jcfg.config_to_json(cfg))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def test_adam_matches_optax_over_five_steps(rng):
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-6, 0)).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lrs = [2e-4, 2e-4, 1e-3, 5e-4, 2e-4]

    tx = adam_tx(0.5)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(tp, beta1=0.5)
    for g, lr in zip(grads, lrs):
        jp, state = apply_updates(tx, jp, [jnp.asarray(x) for x in g], state,
                                  jnp.asarray(lr, jnp.float32))
        opt.step([torch.from_numpy(x) for x in g], lr)
    for a, b in zip(tp, jp):
        # float32 rounding of the same formula: far under one lr step
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _configs(mod):
    teacher = mod.InceptionGeneratorConfig.make(ngf=64, channels_reduction_factor=6,
                                                kernel_sizes=(1, 3, 5), n_blocks=9)
    pruned = dataclasses.replace(
        teacher, ds_channels=(16, 40, 96), us_channels=(30, 16),
        blocks=(mod.InceptionBlockConfig(dim=96, res_channels=(3, 0, 7),
                                         dw_channels=(0, 5, 2), res_kernels=(1, 3, 5),
                                         dw_kernels=(1, 3, 5)),) * 2,
        norm=mod.NormConfig(kind="none", affine=False), padding_type="zero",
        dropout_rate=0.5,
    )
    disc = mod.NLayerDiscriminatorConfig(input_nc=6, ndf=32, n_layers=2)
    return [teacher, pruned, disc, mod.NormConfig(eps=1e-3)]


def test_config_json_round_trips_both_ways():
    for jc, tc in zip(_configs(jcfg), _configs(tcfg)):
        assert tcfg.config_from_json(jcfg.config_to_json(jc)) == tc
        assert jcfg.config_from_json(tcfg.config_to_json(tc)) == jc
        assert tcfg.config_to_json(tc) == jcfg.config_to_json(jc)


# ---------------------------------------------------------------------------
# Shrink (numpy: flagship widths)
# ---------------------------------------------------------------------------


def test_shrink_picks_the_jax_config_macs_and_weights():
    jt = jcfg.InceptionGeneratorConfig.make(ngf=64, channels_reduction_factor=6,
                                            kernel_sizes=(1, 3, 5), n_blocks=9)
    teacher = InceptionGenerator(to_port(jt), generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    sd = {k: (torch.from_numpy(rs.uniform(0.05, 2.0, v.shape).astype(np.float32))
              if v.dim() == 1 and k.endswith(".weight") else v)
          for k, v in teacher.state_dict().items()}
    _, jvars = import_inception_generator({k: v.numpy() for k, v in sd.items()}, jt)

    jres = jax_shrink(jt, jvars, 2.6e9, 256, 256, JBounds(cin_lb=16))
    tres = shrink_generator(to_port(jt), sd, 2.6e9, 256, 256, PruneBounds(cin_lb=16))
    assert tres.config == to_port(jres.config)
    assert tres.searched_macs == jres.searched_macs
    assert tres.searched_macs == profile_generator(tres.config, 256, 256).macs
    assert tres.threshold == jres.threshold
    # the sliced weights are the same tensors in either layout
    _, back = import_inception_generator({k: v.numpy() for k, v in tres.state_dict.items()},
                                         jres.config)
    flat_t, flat_j = _flatten(back["params"]), _flatten(jres.variables["params"])
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    # and they load into the student
    InceptionGenerator(tres.config).load_state_dict(tres.state_dict)


# ---------------------------------------------------------------------------
# The KA-distillation step
# ---------------------------------------------------------------------------


def _gen_cfg(ngf):
    return jcfg.InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                              kernel_sizes=(1, 3, 5), n_blocks=2)


def _hp(cls, **kw):
    return cls(dataset_mode="unaligned", gan_mode="lsgan", distill_loss_type="ka",
               lambda_recon=5.0, mapping_layers=("encode", "block1"), **kw)


def test_train_step_matches_jax_after_one_and_three_steps(rng):
    """The flagship step (unaligned, lsgan, KA over two taps, packed blocks)
    at tiny size in float32, from the same weights and batch."""
    teacher_cfg, student_cfg = _gen_cfg(8), _gen_cfg(4)
    disc_cfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8)
    batch = {"A": rng.randn(2, SIZE, SIZE, 3).astype(np.float32),
             "B": rng.randn(2, SIZE, SIZE, 3).astype(np.float32)}

    jd = JDistiller(teacher_cfg, student_cfg, disc_cfg, hp=_hp(JHP))
    tv = fast_init(jd.netG_teacher, jnp.zeros((1, SIZE, SIZE, 3)), seed=7)
    sv = fast_init(jd.netG_student, jnp.zeros((1, SIZE, SIZE, 3)), seed=8)
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), SIZE, SIZE, tv, sv)

    td = InceptionDistiller(to_port(teacher_cfg), to_port(student_cfg), to_port(disc_cfg),
                            hp=_hp(DistillHParams), device="cpu")
    tstate, tparams = td.init_state(
        jax_import.generator_state_dict(tv["params"], teacher_cfg),
        jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
        jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg),
    )
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in batch.items()}

    for step in (1, 2, 3):
        jstate, jm = jd.train_step(jstate, tv, jbatch, LR)
        tstate, tm = td.train_step(tstate, tparams, tbatch, LR)
        if step == 2:
            continue
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        for name, ref, got in (
            ("G", jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
             td.netG_student.state_dict()),
            ("D", jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg),
             td.netD.state_dict()),
        ):
            assert ref.keys() == got.keys()
            diff = {k: (got[k] - ref[k]).abs() for k in ref}
            # Adam moves a parameter by about lr per step whatever the size of
            # its gradient, so where the two runs disagree on the sign of a
            # gradient that is zero up to float32 noise (the bias of a conv
            # that feeds an instance norm) they part by up to ~2·lr per step ...
            assert max(float(d.max()) for d in diff.values()) <= 2.5 * LR * step, name
            # ... while the conv weights, whose gradients are not zero, agree
            # far closer: all but a sliver of their entries within lr/10
            w = torch.cat([d.flatten() for k, d in diff.items() if d.dim() > 1])
            assert float((w > 0.1 * LR).float().mean()) < 1e-3, name
    assert tstate.step == 3
    out = td.generate_student(tstate, tbatch["A"])
    assert out.shape == tbatch["A"].shape


def test_bf16_step_keeps_float32_masters(rng):
    hp = DistillHParams(dataset_mode="aligned", gan_mode="hinge", lambda_recon=5.0,
                        mapping_layers=("encode", "block1"), compute_dtype="bfloat16",
                        fused_norms=True, packed_blocks=False)
    td = InceptionDistiller(to_port(_gen_cfg(8)), to_port(_gen_cfg(4)), hp=hp, device="cpu")
    teacher = InceptionGenerator(to_port(_gen_cfg(8)), generator=torch.Generator().manual_seed(1))
    state, tparams = td.init_state(teacher.state_dict())
    x = torch.from_numpy(rng.randn(2, 3, SIZE, SIZE).astype(np.float32))
    state, m = td.train_step(state, tparams, {"A": x, "B": x.flip(0)}, LR)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.g.params.values())
    assert all(p.dtype == torch.float32 for p in state.d.params.values())


def _flat_cast_nets():
    """(net, input) of each GAN network the distillers cast under bf16, at
    toy widths."""
    from cat_tpu_torch.core import spade_config as sc
    from cat_tpu_torch.models.discriminators import NLayerDiscriminator
    from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator

    gen = torch.Generator().manual_seed(3)
    spade = dict(semantic_nc=5, channels_reduction_factor=8, kernel_sizes=(3,),
                 num_upsampling_layers="normal", crop_size=64, aspect_ratio=2.0)
    x = torch.randn(2, 3, SIZE, SIZE, generator=gen)
    sem = torch.randn(2, 5, 32, 64, generator=gen)
    return {
        "inception": lambda: (InceptionGenerator(to_port(_gen_cfg(5)), generator=gen), x),
        "inception_fused": lambda: (InceptionGenerator(to_port(_gen_cfg(5)), fused_norms=True,
                                                       generator=gen), x),
        "spade": lambda: (SPADEGenerator(sc.SPADEGeneratorConfig.make(ngf=6, **spade),
                                         generator=gen), sem),
        "nlayer": lambda: (NLayerDiscriminator(tcfg.NLayerDiscriminatorConfig(ndf=5),
                                               generator=gen), x),
        "multiscale": lambda: (MultiscaleDiscriminator(sc.MultiscaleDiscriminatorConfig(
            input_nc=5, ndf=5, n_layers=3, num_D=2), generator=gen), sem),
    }


@pytest.mark.parametrize("net", ["inception", "inception_fused", "spade", "nlayer",
                                 "multiscale"])
def test_flat_cast_equals_the_per_tensor_cast(net):
    """``cast_flat`` of a GAN network's parameters with nothing kept (how
    ``Precision`` casts them under bf16): every piece equal to its own bf16
    cast, and the float32 gradients back through it equal to those back
    through one cast a tensor."""
    from cat_tpu_torch.train.common import cast_flat, cast_floats

    module, x = _flat_cast_nets()[net]()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in module.named_parameters()}
    flat = cast_flat(params, torch.bfloat16)
    assert list(flat) == list(params)
    for k, v in flat.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, params[k].to(torch.bfloat16)), k
    twin = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    per = {k: v.to(torch.bfloat16) for k, v in twin.items()}

    def loss(p):
        out = cast_floats(torch.func.functional_call(module, p, (x.bfloat16(),)),
                          torch.float32)
        leaves = [out] if torch.is_tensor(out) else [t for scale in out for t in scale]
        return sum(t.square().mean() for t in leaves)

    grads = [torch.autograd.grad(loss(p), list(leaves.values()))
             for p, leaves in ((flat, params), (per, twin))]
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_teacher_hyperparameters_build_and_check(rng, mode):
    """The int8 teachers (refused until the int8 convolutions were ported):
    the distiller builds and steps; int8_static calibrates on its first
    batch, int8 keeps no scales; an unknown teacher dtype raises."""
    hp = DistillHParams(mapping_layers=("encode",), teacher_compute_dtype=mode)
    td = InceptionDistiller(to_port(_gen_cfg(8)), to_port(_gen_cfg(4)), hp=hp, device="cpu")
    state, tparams = td.init_state(InceptionGenerator(
        to_port(_gen_cfg(8)), packed_blocks=True,
        generator=torch.Generator().manual_seed(1)).state_dict())
    x = torch.from_numpy(rng.randn(2, 3, SIZE, SIZE).astype(np.float32))
    state, m = td.train_step(state, tparams, {"A": x, "B": x.flip(0)}, LR)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert (td._act_scales is None) == (mode == "int8")
    with pytest.raises(ValueError, match="teacher_compute_dtype"):
        InceptionDistiller(to_port(_gen_cfg(8)), to_port(_gen_cfg(4)),
                           hp=DistillHParams(teacher_compute_dtype="int4"), device="cpu")


@pytest.mark.parametrize("family", ["inception", "spade", "generic"])
def test_distillers_refuse_unknown_dtypes_and_losses(family):
    """Each distiller refuses, before it builds anything, a compute dtype
    outside float32/bfloat16 (``ValueError``) and a distillation loss other
    than ka/mse (``NotImplementedError``)."""
    from cat_tpu_torch.core.spade_config import SPADEGeneratorConfig
    from cat_tpu_torch.distill.generic import GenericDistiller, GenericDistillHParams
    from cat_tpu_torch.distill.spade_distiller import SPADEDistiller, SPADEDistillHParams

    def build(**kw):
        if family == "inception":
            return InceptionDistiller(to_port(_gen_cfg(8)), to_port(_gen_cfg(4)),
                                      hp=DistillHParams(**kw), device="cpu")
        if family == "spade":
            cfg = SPADEGeneratorConfig.make(ngf=8)
            return SPADEDistiller(cfg, cfg, hp=SPADEDistillHParams(**kw), device="cpu")
        return GenericDistiller(torch.nn.Identity(), torch.nn.Identity(), {}, {},
                                GenericDistillHParams(**kw), device="cpu")

    with pytest.raises(ValueError, match=r"compute_dtype must be one of \['bfloat16', "
                                         r"'float32'\]"):
        build(compute_dtype="float16")
    with pytest.raises(NotImplementedError, match="l1"):
        build(distill_loss_type="l1")
    assert build(compute_dtype="bfloat16").prec.dtype == torch.bfloat16


def test_entry_point_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InceptionDistiller(to_port(_gen_cfg(8)), to_port(_gen_cfg(4)))


# ---------------------------------------------------------------------------
# The mse + adaptor, EMA and remat paths
# ---------------------------------------------------------------------------


def _close_params(ref, got, step, what):
    """The Adam tolerance of the KA test above: at most ~2·lr per step where
    a near-zero gradient's sign differs, and all but a sliver of the conv
    weights within lr/10."""
    assert ref.keys() == got.keys(), what
    diff = {k: (got[k].detach() - ref[k]).abs() for k in ref}
    assert max(float(d.max()) for d in diff.values()) <= 2.5 * LR * step, what
    w = torch.cat([d.flatten() for d in diff.values() if d.dim() > 1])
    assert float((w > 0.1 * LR).float().mean()) < 1e-3, what


def _jax_state_file_loads_into_the_port(tmp_path, jstate, td, student_cfg, disc_cfg):
    """The JAX package's full-state file restores into a port state: the
    same parameters, adaptors, EMA, Adam moments and counts, and step,
    exactly (the moments take the parameters' layout changes)."""
    jckpt.save_train_state(str(tmp_path), "latest", jstate)
    port = td.init_state(td.netG_teacher.state_dict(), seed=11)[0]
    sd = jax_import.distill_state_dict(ckpt.read_msgpack(str(tmp_path / "latest_state.msgpack")),
                                       to_port(student_cfg), to_port(disc_cfg), adaptors=True)
    load_train_state_dict(port, sd)
    assert port.step == int(jstate.step) == 3
    g_names = [*port.g.params, *(f"A.{k}" for k in port.adaptors)]
    want = {
        "G": jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
        "A": jax_import.adaptor_state_dict(jstate.g.params["A"]),
        "ema": jax_import.generator_state_dict(jstate.extra["ema_G"], student_cfg),
        "D": jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg),
        "D mu": jax_import.nlayer_discriminator_state_dict(jstate.d.opt_state.mu, disc_cfg),
        "G mu": {**jax_import.generator_state_dict(jstate.g.opt_state.mu["G"], student_cfg),
                 **{f"A.{k}": v for k, v in
                    jax_import.adaptor_state_dict(jstate.g.opt_state.mu["A"]).items()}},
    }
    got = {"G": port.g.params, "A": port.adaptors, "ema": port.extra["ema_G"],
           "D": port.d.params, "D mu": dict(zip(port.d.params, port.d.opt.mu)),
           "G mu": dict(zip(g_names, port.g.opt.mu))}
    for what, ref in want.items():
        assert got[what].keys() == ref.keys(), what
        assert all(torch.equal(got[what][k], ref[k]) for k in ref), what
    assert port.g.opt.count == port.d.opt.count == 3


def test_mse_adaptor_ema_remat_step_matches_jax_after_one_and_three_steps(rng, tmp_path):
    """mse distillation through the adaptors (trained with the student by
    one Adam), the student-weight EMA and the rematerialised student
    forward, all on, at tiny size in float32 from the same weights and
    batch.  Losses within rtol 1e-4 / atol 1e-6 (float32 sums in another
    order); parameters, adaptors and EMA within the Adam tolerance above."""
    teacher_cfg, student_cfg = _gen_cfg(8), _gen_cfg(4)
    disc_cfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8)
    batch = {"A": rng.randn(2, SIZE, SIZE, 3).astype(np.float32),
             "B": rng.randn(2, SIZE, SIZE, 3).astype(np.float32)}
    kw = dict(distill_loss_type="mse", ema_decay=0.9, remat=True)

    jd = JDistiller(teacher_cfg, student_cfg, disc_cfg, hp=dataclasses.replace(_hp(JHP), **kw))
    tv = fast_init(jd.netG_teacher, jnp.zeros((1, SIZE, SIZE, 3)), seed=7)
    sv = fast_init(jd.netG_student, jnp.zeros((1, SIZE, SIZE, 3)), seed=8)
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), SIZE, SIZE, tv, sv)

    td = InceptionDistiller(to_port(teacher_cfg), to_port(student_cfg), to_port(disc_cfg),
                            hp=dataclasses.replace(_hp(DistillHParams), **kw), device="cpu")
    tstate, tparams = td.init_state(
        jax_import.generator_state_dict(tv["params"], teacher_cfg),
        jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
        jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg),
    )
    with torch.no_grad():
        for k, v in jax_import.adaptor_state_dict(jstate.g.params["A"]).items():
            tstate.adaptors[k].copy_(v)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in batch.items()}

    for step in (1, 2, 3):
        jstate, jm = jd.train_step(jstate, tv, jbatch, LR)
        tstate, tm = td.train_step(tstate, tparams, tbatch, LR)
        if step == 2:
            continue
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {step} {k}")
        _close_params(jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
                      td.netG_student.state_dict(), step, "G")
        _close_params(jax_import.generator_state_dict(jstate.extra["ema_G"], student_cfg),
                      tstate.extra["ema_G"], step, "EMA of G")
        _close_params(jax_import.adaptor_state_dict(jstate.g.params["A"]), tstate.adaptors,
                      step, "adaptors")
        _close_params(jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg),
                      td.netD.state_dict(), step, "D")
    # evaluation and deployment take the EMA weights
    assert td.student_eval_params(tstate) is tstate.extra["ema_G"]
    _jax_state_file_loads_into_the_port(tmp_path, jstate, td, student_cfg, disc_cfg)
    x = tbatch["A"]
    ema_out = td.generate_student(tstate, x)
    with torch.no_grad():
        raw_out = td.netG_student(x)
    assert not torch.equal(ema_out, raw_out)


def test_remat_gives_the_same_step_bit_for_bit(rng):
    """Recomputing the student forward in the backward changes no value:
    the same losses and parameters as the stored forward, exactly, with
    dropout on (the recompute redraws the same masks)."""
    cfg = dataclasses.replace(to_port(_gen_cfg(4)), dropout_rate=0.3)
    teacher = InceptionGenerator(to_port(_gen_cfg(8)), generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.randn(2, 3, SIZE, SIZE).astype(np.float32))
    out = []
    for remat in (False, True):
        hp = dataclasses.replace(_hp(DistillHParams), remat=remat)
        td = InceptionDistiller(to_port(_gen_cfg(8)), cfg, hp=hp, device="cpu")
        state, tp = td.init_state(teacher.state_dict(), seed=3)
        for _ in range(2):
            state, m = td.train_step(state, tp, {"A": x, "B": x.flip(0)}, LR)
        out.append((m, {k: v.detach().clone() for k, v in state.g.params.items()},
                    state.rng.get_state()))
    (m0, p0, r0), (m1, p1, r1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(r0, r1)


# ---------------------------------------------------------------------------
# LR schedules and the trainer (mirrors tests/test_trainer.py)
# ---------------------------------------------------------------------------

from cat_tpu.train import optim as joptim  # noqa: E402
from cat_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from cat_tpu.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from cat_tpu.utils.logger import Logger as JLogger  # noqa: E402
from cat_tpu_torch.train import optim as toptim  # noqa: E402
from cat_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from cat_tpu_torch.utils.logger import Logger  # noqa: E402


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_lr_schedules_equal_the_jax_package(policy):
    kw = dict(nepochs=7, nepochs_decay=5, lr_decay_iters=3)
    for epoch in range(14):
        assert (toptim.schedule_lr(policy, epoch, 2e-4, **kw)
                == joptim.schedule_lr(policy, epoch, 2e-4, **kw)), epoch


def test_lr_schedules():
    assert toptim.linear_lr(0, 2e-4, 100, 100) == 2e-4
    assert toptim.linear_lr(99, 2e-4, 100, 100) == 2e-4
    assert toptim.linear_lr(199, 2e-4, 100, 100) < 2e-5
    assert abs(toptim.step_lr(100, 1.0, 50) - 0.01) < 1e-12
    assert abs(toptim.cosine_lr(0, 1.0, 100) - 1.0) < 1e-9
    p, jp = toptim.PlateauLR(1.0, patience=1), joptim.PlateauLR(1.0, patience=1)
    for metric in (1.0, 1.0, 1.0, 0.5, 0.5, 0.4999, 0.3, 0.3, 0.3, 0.3):
        assert p.update(metric) == jp.update(metric)
    assert p.lr == pytest.approx(0.2 ** 3)
    with pytest.raises(ValueError):
        toptim.schedule_lr("plateau", 0, 1.0)
    with pytest.raises(NotImplementedError):
        toptim.schedule_lr("exponential", 0, 1.0)


class FakeLoader:
    def __init__(self, n_batches, tensors=True):
        self.n, self.tensors = n_batches, tensors

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            x = np.full((2, 2), float(i), np.float32)
            yield {"x": torch.from_numpy(x) if self.tensors else x}


def _run_trainer(cls, cfg_cls, logger_cls, tmp_path, evaluate, copy_tag, as_metric, **cfg):
    calls = {"steps": [], "evals": [], "saves": [], "copies": []}

    def step_fn(state, batch, lr):
        calls["steps"].append(lr)
        return state + 1, {"loss": as_metric(float(state))}

    def evaluate_fn(state, step):
        calls["evals"].append(step)
        return {"metric/fid": 100.0 if len(calls["evals"]) == 1 else 99.9}, {"is_best": True}

    trainer = cls(step_fn, FakeLoader(3, cls is Trainer), cfg_cls(log_dir=str(tmp_path), **cfg),
                  evaluate_fn if evaluate else None,
                  lambda state, tag: calls["saves"].append(tag), logger_cls(str(tmp_path)),
                  copy_tag_fn=(lambda s, d: calls["copies"].append((s, d))) if copy_tag else None)
    calls["final"] = trainer.fit(0)
    return calls


@pytest.mark.parametrize("evaluate,copy_tag,cfg", [
    # cadence: eval at iter_base, every 3 iterations and at epochs 2 and 4
    (True, False, dict(nepochs=2, nepochs_decay=2, print_freq=2, save_latest_freq=3,
                       save_epoch_freq=2, lr=1.0)),
    # no evaluators: 'latest' still saved at cadence, and per epoch
    (False, False, dict(nepochs=1, nepochs_decay=1, print_freq=10, save_latest_freq=2,
                        save_epoch_freq=1, lr=1.0)),
    # one serialisation per multi-tag save, the rest copied
    (True, True, dict(nepochs=1, nepochs_decay=0, print_freq=10, save_latest_freq=100,
                      save_epoch_freq=1, lr=1.0)),
    # plateau: a stalled metric decays the LR after `patience` epochs
    (True, True, dict(nepochs=12, nepochs_decay=0, print_freq=1000, save_latest_freq=10**9,
                      save_epoch_freq=1, lr=1.0, lr_policy="plateau")),
])
def test_trainer_cadence_equals_the_jax_package(tmp_path, evaluate, copy_tag, cfg):
    """The same steps, LRs, evaluations, saves and tag copies as the JAX
    package's Trainer."""
    got = _run_trainer(Trainer, TrainerConfig, Logger, tmp_path / "port", evaluate, copy_tag,
                       torch.tensor, **cfg)
    ref = _run_trainer(JTrainer, JTrainerConfig, JLogger, tmp_path / "jax", evaluate, copy_tag,
                       jnp.asarray, **cfg)
    assert got == ref
    assert "latest" in got["saves"]
    if cfg.get("lr_policy") == "plateau":
        assert got["steps"][0] == 1.0 and got["steps"][-1] == 0.2
    # the logger writes the JAX package's lines
    for name in ("log.txt", "scalars.jsonl"):
        a = (tmp_path / "port" / name).read_text().splitlines()
        b = (tmp_path / "jax" / name).read_text().splitlines()
        assert len(a) == len(b)
        if name == "log.txt":  # but for the times
            strip = lambda s: re.sub(r"(time: |Time Taken: )[0-9.]+", r"\1", s)
            assert [strip(s) for s in a] == [strip(s) for s in b]
