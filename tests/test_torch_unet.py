"""The port's diffusion UNet (``cat_tpu_torch/models/unet.py``) and
``GenericDistiller`` (``cat_tpu_torch/distill/generic.py``) against the JAX
package's (CPU, ``tests/test_unet_distill.py``'s sizes: teacher base 8,
student base 4, mults (1, 2), one res block, time_dim 16, groups 4, 16 px,
inputs made with numpy from a seed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cat_tpu.distill.generic import GenericDistillHParams as JHP
from cat_tpu.distill.generic import GenericDistiller as JDistiller
from cat_tpu.models.unet import UNet as JUNet
from cat_tpu.models.unet import UNetConfig as JCfg
from cat_tpu_torch.distill import ka as tka
from cat_tpu_torch.distill.generic import GenericDistillHParams, GenericDistiller
from cat_tpu_torch.models.unet import UNet, UNetConfig
from cat_tpu_torch.utils import jax_import
from tests.conftest import fast_init

torch.set_num_threads(1)

SIZE = 16
LR = 1e-3


def _cfgs(base, cls):
    return cls(in_channels=3, out_channels=3, base=base, mults=(1, 2), res_blocks=1,
               time_dim=16, groups=4)


def _port(jparams, base):
    net = UNet(_cfgs(base, UNetConfig))
    net.load_state_dict(jax_import.unet_state_dict(jax.tree.map(np.asarray, jparams)))
    return net


def _inputs(rng):
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    t = np.array([3.0, 7.0], np.float32)
    return (jnp.asarray(x), jnp.asarray(t)), (torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                              torch.from_numpy(t))


def test_unet_forward_and_taps_match_jax(rng):
    """Output and every tap (down0, down1, mid, up0, up1) at 1e-5 of their
    largest value, with the timestep embedding; without a timestep too; the
    tap widths are the config's."""
    jnet = JUNet(_cfgs(8, JCfg))
    v = fast_init(jnet, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)), seed=3)
    net = _port(v["params"], 8)
    (jx, jt), (x, t) = _inputs(rng)
    taps = ("down0", "down1", "mid", "up0", "up1")
    for args, targs in (((jx, jt), (x, t)), ((jx,), (x,))):
        want, wacts = jnet.apply(v, *args, taps=taps)
        with torch.no_grad():
            got, acts = net(*targs, taps=taps)
        for name, g, w in [("out", got, want)] + [(k, acts[k], wacts[k]) for k in taps]:
            w = np.asarray(w).transpose(0, 3, 1, 2)
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
        assert {k: a.shape[1] for k, a in acts.items()} == {
            k: w for k, w in net.cfg.tap_widths.items() if k in taps}


@pytest.mark.parametrize("loss,dtype", [("ka", "float32"), ("mse", "float32"),
                                        ("ka", "bfloat16"), ("mse", "bfloat16")])
def test_generic_distiller_steps_match_jax(rng, loss, dtype):
    """Three ``GenericDistiller`` steps (taps mid and up0) from the same
    weights and inputs: losses at rtol 1e-4 in float32 (2e-2 in bf16, where
    torch and XLA round the casts between layers at other places), the
    student within Adam's 2.5·lr·steps of the JAX student, the adaptors too
    (mse); KA's Gram runs twice a tap; float32 masters under bf16; the
    reconstruction falls over the steps."""
    t_cfg, s_cfg = _cfgs(8, JCfg), _cfgs(4, JCfg)
    taps = ("mid", "up0")
    kw = dict(distill_loss_type=loss, mapping_layers=taps, lambda_recon=1.0,
              lambda_distill=1.0, compute_dtype=dtype)
    jd = JDistiller(JUNet(t_cfg), JUNet(s_cfg), t_cfg.tap_widths, s_cfg.tap_widths, JHP(**kw))
    (jx, jt), (x, t) = _inputs(rng)
    tv = fast_init(JUNet(t_cfg), jx, jt, seed=7)
    jstate, tv = jd.init_state(jax.random.PRNGKey(0), (jx, jt), tv)
    student = _port(jstate.g.params["G"], 4)
    dist = GenericDistiller(_port(tv["params"], 8), student, t_cfg.tap_widths,
                            s_cfg.tap_widths, GenericDistillHParams(**kw), device="cpu")
    state, tparams = dist.init_state(seed=1)
    with torch.no_grad():
        for k, v in jax_import.adaptor_state_dict(jstate.g.params["A"]).items():
            state.adaptors[k].copy_(v)
    rtol = 1e-4 if dtype == "float32" else 2e-2
    calls = []
    gram = tka.gram
    tka.gram = lambda a: calls.append(a.shape) or gram(a)
    try:
        for step in (1, 2, 3):
            jstate, jm = jd.train_step(jstate, tv, (jx, jt), LR)
            state, m = dist.train_step(state, tparams, (x, t), LR)
            assert m.keys() == jm.keys()
            for k in jm:
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, atol=1e-6,
                                           err_msg=f"step {step} {k}")
            first = float(m["G_loss/recon"]) if step == 1 else first
    finally:
        tka.gram = gram
    assert len(calls) == (2 * len(taps) * 3 if loss == "ka" else 0)
    assert float(m["G_loss/recon"]) < first
    assert all(p.dtype == torch.float32 for p in state.params.values())
    ref = jax_import.unet_state_dict(jax.tree.map(np.asarray, jstate.g.params["G"]))
    worst = max(float((state.params[k].detach() - v).abs().max()) for k, v in ref.items())
    assert worst <= 2.5 * LR * 3, worst
    if loss == "mse":
        ref = jax_import.adaptor_state_dict(jax.tree.map(np.asarray, jstate.g.params["A"]))
        worst = max(float((state.adaptors[k].detach() - v).abs().max()) for k, v in ref.items())
        assert worst <= 2.5 * LR * 3, worst
    out = dist.generate(state, x, t)
    assert out.shape == x.shape
