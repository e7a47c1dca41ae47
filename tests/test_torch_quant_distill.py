"""The int8 frozen teacher (``--teacher_compute_dtype int8|int8_static``) in
both distillers of the port against the JAX package's steps (CPU, float32,
the setups of ``tests/test_quant.py``: a one-block inception teacher, a
SPADE teacher of ngf 16), and the calibration that ``int8_static`` runs on
the first batch.

The JAX steps are jitted, and XLA reassociates the float32 arithmetic
around the convs (the norms; ``max / 127`` becomes a multiply by 1/127):
a teacher conv's input then differs from the port's by ~1e-7, and an int8
value on a rounding boundary can flip by one, moving the layers after it
(``tests/test_torch_quant.py`` holds each conv exactly, and the toy
teachers against the JAX interpreter run eagerly).  On these teachers the
KA terms still agree to ~2e-7.  Step 1's losses are held at the distill
steps' rtol 1e-4; later SPADE steps at ``chip_smoke.py``'s DP_LOSS_TOL
bound, 1e-3·max(|loss|, 0.1): Adam turns float32 noise on a near-zero
gradient of D into a full ±lr step (the G GAN loss of -0.0317 moves by
~2e-5, as ``tests/test_torch_parallel.py`` found without int8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.core import config as jcfg
from cat_tpu.distill.inception_distiller import DistillHParams as JHP
from cat_tpu.distill.inception_distiller import InceptionDistiller as JDistiller
from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.distill.inception_distiller import DistillHParams, InceptionDistiller
from cat_tpu_torch.ops.quant import teacher_forward
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init
from tests.test_torch_quant import _inception
from tests.test_torch_spade import _close
from tests.test_torch_spade_distill import LR, _batch, _compare_states, _worlds
from tests.test_torch_train import SIZE, _close_params, _gen_cfg, to_port

torch.set_num_threads(1)

DP_LOSS_TOL = 1e-3  # chip_smoke.py's bound on a later step's losses


def _hp(cls, mode):
    return cls(dataset_mode="unaligned", gan_mode="lsgan", distill_loss_type="ka",
               lambda_recon=5.0, mapping_layers=("encode",), teacher_compute_dtype=mode)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_inception_int8_teacher_steps_match_jax(rng, mode):
    """Two steps of the inception distiller with the int8 teacher (tests/
    test_quant.py's one-block setup): losses at rtol 1e-4, parameters within
    Adam's 2.5·lr·steps; ``int8_static`` calibrates on the first batch, as
    many scales as the JAX distiller's, equal at rtol 1e-6, and keeps them."""
    teacher_cfg, student_cfg = _gen_cfg(8), _gen_cfg(4)
    teacher_cfg = dataclasses.replace(teacher_cfg, blocks=teacher_cfg.blocks[:1])
    student_cfg = dataclasses.replace(student_cfg, blocks=student_cfg.blocks[:1])
    batch = {"A": rng.randn(2, SIZE, SIZE, 3).astype(np.float32),
             "B": rng.randn(2, SIZE, SIZE, 3).astype(np.float32)}
    disc_cfg = jcfg.NLayerDiscriminatorConfig(input_nc=3, ndf=8)
    jd = JDistiller(teacher_cfg, student_cfg, disc_cfg, hp=_hp(JHP, mode))
    tv = fast_init(jd.netG_teacher, jnp.zeros((1, SIZE, SIZE, 3)), seed=7)
    sv = fast_init(jd.netG_student, jnp.zeros((1, SIZE, SIZE, 3)), seed=8)
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), SIZE, SIZE, tv, sv)
    td = InceptionDistiller(to_port(teacher_cfg), to_port(student_cfg), to_port(disc_cfg),
                            hp=_hp(DistillHParams, mode), device="cpu")
    tstate, tparams = td.init_state(
        jax_import.generator_state_dict(tv["params"], teacher_cfg),
        jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
        jax_import.nlayer_discriminator_state_dict(jstate.d.params, disc_cfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in batch.items()}
    assert td._act_scales is None
    for step in (1, 2):
        jstate, jm = jd.train_step(jstate, tv, jbatch, LR)
        tstate, tm = td.train_step(tstate, tparams, tbatch, LR)
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{mode} step {step} {k}")
        _close_params(jax_import.generator_state_dict(jstate.g.params["G"], student_cfg),
                      td.netG_student.state_dict(), step, "G")
    if mode == "int8_static":
        assert len(td._act_scales) == len(jd._act_scales) > 5
        np.testing.assert_allclose(td._act_scales, jd._act_scales, rtol=1e-6)
        scales = td._act_scales
        td.train_step(tstate, tparams, {k: v.flip(0) for k, v in tbatch.items()}, LR)
        assert td._act_scales is scales  # calibrated once
    else:
        assert td._act_scales is None


def test_calibrate_teacher_counts_the_teachers_convs():
    """The first ``int8_static`` teacher forward (``teacher_forward`` with
    no scales yet) calibrates one scale per conv of the teacher's forward,
    in its order: the packed toy teacher's 20 (ngf 8, two blocks of kernels
    1, 3, 5) and the unpacked one's 36, as cat_tpu's interpreter counts them
    (tests/test_torch_quant.py holds the values); its outputs are those of
    the static forward at the scales it took."""
    for packed, n in ((True, 20), (False, 36)):
        _, _, tg, x, taps = _inception(packed)
        hp = DistillHParams(mapping_layers=taps, teacher_compute_dtype="int8_static",
                            packed_blocks=packed)
        td = InceptionDistiller(tg.cfg, tg.cfg, hp=hp, device="cpu")
        td.init_state(tg.state_dict())
        params = dict(td.netG_teacher.named_parameters())
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        out, scales = teacher_forward(td._teacher_fn, params, xt, "int8_static", None)
        assert len(scales) == n and all(s > 0 for s in scales)
        again, kept = teacher_forward(td._teacher_fn, params, xt, "int8_static", scales)
        assert kept is scales
        torch.testing.assert_close(again, out, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_spade_int8_teacher_steps_match_jax(rng, tmp_path, mode):
    """Two steps of the SPADE distiller (KA on the three default taps, ngf 16
    teacher) with the int8 teacher against the JAX distiller: losses as the
    module's docstring says, parameters, adaptors and statistics as
    ``tests/test_torch_spade_distill.py`` holds them; the Gram runs twice a
    tap; ``int8_static``'s scales equal the JAX calibration's."""
    jdist, jstate, tv, dist, state, tparams = _worlds(
        tmp_path, None, distill_loss_type="ka", lambda_vgg=0.0, teacher_compute_dtype=mode)
    jbatch, tbatch = _batch(rng)
    calls = []
    gram = tka.gram
    tka.gram = lambda x: calls.append(x.shape) or gram(x)
    try:
        for step in (1, 2):
            jstate, jm = jdist.train_step(jstate, tv, jbatch, LR)
            state, tm = dist.train_step(state, tparams, tbatch, LR)
            assert tm.keys() == jm.keys()
            for k in jm:
                want = float(jm[k])
                tol = (dict(rtol=1e-4, atol=1e-6) if step == 1 or k.startswith("Specific")
                       else dict(rtol=0, atol=DP_LOSS_TOL * max(abs(want), 0.1)))
                _close(float(tm[k]), want, f"{mode} step {step} {k}", **tol)
            _compare_states(jstate, state, dist, tmp_path, step)
    finally:
        tka.gram = gram
    assert len(calls) == 6 * 2
    if mode == "int8_static":
        assert len(dist._act_scales) == len(jdist._act_scales) > 20
        np.testing.assert_allclose(dist._act_scales, jdist._act_scales, rtol=1e-6)
