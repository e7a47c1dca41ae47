"""The distill step on the map2sat student's norm (tracked batch norm: the
student's forward moves its statistics, D's fake and real forwards move
D's, the G loss's D forward and the penalty's leave them, the teacher
normalises with its own) and under wgangp (the gradient penalty), each
held against the JAX package's distiller for one step (CPU, float32).
The JAX side runs as ``tests/test_torch_teacher.py`` explains."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.core import config as jcfg
from cat_tpu.distill.inception_distiller import DistillHParams as JHP
from cat_tpu.distill.inception_distiller import InceptionDistiller as JDistiller
from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
from cat_tpu_torch.utils import jax_import
from tests.test_torch_teacher import (LR, SIZE, _close, _params_close, fixed_alpha,
                                      jax_stats_left_alone, nchw, to_port)

torch.set_num_threads(1)

CASES = {
    # scripts/pix2pix/map2sat/train_inception_student_4p6B.sh's norm and mode
    "batch-norm": dict(norm="batch", dataset_mode="aligned", gan_mode="hinge"),
    "wgangp": dict(norm="instance", dataset_mode="unaligned", gan_mode="wgangp"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_distill_step_matches_jax(rng, monkeypatch, case):
    jax_stats_left_alone(monkeypatch)
    fixed_alpha(monkeypatch)
    c = CASES[case]
    norm = jcfg.NormConfig(kind=c["norm"], affine=True,
                           track_running_stats=c["norm"] == "batch")

    def gen_cfg(ngf):
        return jcfg.InceptionGeneratorConfig.make(ngf=ngf, channels_reduction_factor=2,
                                                  kernel_sizes=(1, 3, 5), n_blocks=2, norm=norm)

    teacher_cfg, student_cfg = gen_cfg(8), gen_cfg(4)
    d_in = 6 if c["dataset_mode"] == "aligned" else 3
    disc_cfg = jcfg.NLayerDiscriminatorConfig(input_nc=d_in, ndf=8, norm=norm)
    kw = dict(dataset_mode=c["dataset_mode"], gan_mode=c["gan_mode"], distill_loss_type="ka",
              lambda_recon=5.0, mapping_layers=("encode", "block1"))
    jd = JDistiller(teacher_cfg, student_cfg, disc_cfg, hp=JHP(**kw))
    tv = dict(jd.netG_teacher.init(jax.random.PRNGKey(7), jnp.zeros((1, SIZE, SIZE, 3))))
    if "batch_stats" in tv:  # a trained teacher's statistics, away from (0, 1)
        tv["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, v: (rng.rand(*v.shape) + 0.5 if path[-1].key == "var"
                             else rng.randn(*v.shape) * 0.05).astype(np.float32),
            tv["batch_stats"])
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), SIZE, SIZE, tv)

    td = InceptionDistiller(to_port(teacher_cfg), to_port(student_cfg), to_port(disc_cfg),
                            hp=DistillHParams(**kw), device="cpu")
    state, tparams = td.init_state(
        jax_import.generator_state_dict(tv["params"], teacher_cfg, tv.get("batch_stats")),
        jax_import.generator_state_dict(jstate.g.params["G"], student_cfg, jstate.g.stats),
        jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg, jstate.d.stats),
    )
    batch = {k: rng.randn(2, SIZE, SIZE, 3).astype(np.float32) for k in "AB"}
    jstate, jm = jd.train_step(jstate, tv, {k: jnp.asarray(v) for k, v in batch.items()}, LR)
    state, tm = td.train_step(state, tparams, {k: nchw(v) for k, v in batch.items()}, LR)
    assert tm.keys() == jm.keys()
    for k in jm:
        _close(float(tm[k]), float(jm[k]), k, rtol=1e-4, atol=1e-6)
    for name, ref, net in (
        ("G", jax_import.generator_state_dict(jstate.g.params["G"], student_cfg, jstate.g.stats),
         td.netG_student),
        ("D", jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg,
                                                         jstate.d.stats), td.netD),
    ):
        params = dict(net.named_parameters())
        _params_close(params, {k: ref[k] for k in params}, 1, name)
        stats = dict(net.named_buffers())
        assert bool(stats) == (c["norm"] == "batch")
        for k, v in stats.items():
            _close(v, ref[k], f"{name} {k}", rtol=1e-5, atol=1e-6)
    # the teacher's statistics normalise its eval forward and never move
    for k, v in td.netG_teacher.named_buffers():
        _close(v, jax_import.generator_state_dict(tv["params"], teacher_cfg,
                                                  tv["batch_stats"])[k], k, rtol=0, atol=0)
