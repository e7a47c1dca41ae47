"""The port's DeepLabV2 / MSC (``cat_tpu_torch/metrics/deeplabv2.py``) against
the reference torch implementation's outputs
(``tests/fixtures/deeplabv2_fixture.npz``: random weights, seed 104, a 33 x
33 input whose odd size exercises the ceil-mode max pool and the 0.5
pyramid's 33 -> 16 resize) with the reference state_dict loaded directly,
and against ``cat_tpu``'s MSC in eval and train mode (CPU, float32)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cat_tpu.metrics import deeplabv2 as jdl
from cat_tpu_torch.metrics import MSC, DeepLabV2
from cat_tpu_torch.metrics.deeplabv2 import load_deeplabv2
from cat_tpu_torch.utils import jax_import

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "deeplabv2_fixture.npz")


@pytest.fixture(scope="module")
def fix():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd/")}
    spec = dict(n_classes=4, n_blocks=tuple(int(n) for n in data["n_blocks"]),
                atrous_rates=tuple(int(r) for r in data["rates"]))
    return data, sd, spec


def test_msc_loads_the_reference_state_dict_and_matches_its_outputs(fix):
    """MSC's state_dict is the reference's (``base.`` keys, batch-norm
    counters included): it loads strictly; the base alone through
    ``load_deeplabv2``.  Outputs at the JAX test's tolerance (atol 2e-4,
    rtol 1e-3: the reference's float32 sums in another order)."""
    data, sd, spec = fix
    msc = MSC(DeepLabV2(**spec)).eval()
    msc.load_state_dict(sd)
    base = load_deeplabv2(DeepLabV2(**spec), sd).eval()
    x = torch.from_numpy(np.array(data["x"]))
    with torch.no_grad():
        for got, ref in ((base(x), data["ref_base"]), (msc(x), data["ref_msc"])):
            # the fixture keeps the outputs NHWC
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=2e-4, rtol=1e-3)


def test_pyramid_resize_uses_the_given_factor():
    """torch's bilinear resize with a scale factor reads source coordinates
    at (dst + 0.5) / factor - 0.5 (33 -> 16 at 0.5: a step of 2, not 33/16),
    as ``cat_tpu``'s ``interpolate_bilinear`` does."""
    x = np.random.RandomState(0).randn(1, 33, 33, 2).astype(np.float32)
    want = np.asarray(jdl.interpolate_bilinear(jnp.asarray(x), (16, 16), scale_factor=0.5))
    got = F.interpolate(torch.from_numpy(x.transpose(0, 3, 1, 2)), scale_factor=0.5,
                        mode="bilinear", align_corners=False, recompute_scale_factor=False)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-6)
    sized = F.interpolate(torch.from_numpy(x.transpose(0, 3, 1, 2)), size=(16, 16),
                          mode="bilinear", align_corners=False)
    assert not np.allclose(sized.numpy().transpose(0, 2, 3, 1), want, atol=1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_msc_matches_jax(fix, train):
    """``cat_tpu``'s MSC on the fixture's weights, carried to the port by
    ``jax_import.deeplabv2_state_dict``: the max in eval mode; in train mode
    ``[logits, *pyramid, max]`` with the batch norms still frozen (rtol
    1e-4, atol 1e-5 of each output's largest value)."""
    data, sd, spec = fix
    jvars = jdl.convert_torch_deeplabv2({k: v.numpy() for k, v in sd.items()})
    jmsc = jdl.MSC(base=jdl.DeepLabV2(**spec))
    x = np.array(data["x"])
    want = jmsc.apply({"params": {"base": jvars["params"]}},
                      jnp.asarray(x.transpose(0, 2, 3, 1)), train=train)
    msc = MSC(DeepLabV2(**spec)).train(train)
    msc.base.load_state_dict(jax_import.deeplabv2_state_dict(
        jax.tree.map(np.asarray, jvars["params"])))
    with torch.no_grad():
        got = msc(torch.from_numpy(x))
    if not train:
        got, want = [got], [want]
    assert len(got) == len(want) == (4 if train else 1)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
