"""The int8 teacher's activation scales over ranks (``ops/quant.py``): each
conv's scale is that of the GLOBAL batch, as ``jnp.max`` of a sharded array
is under the JAX package's GSPMD, so two gloo ranks over the batch and two
over the height (``--n_spatial 2``) calibrate the scales of one process and
give its output.  The second sample is three times the first, so a rank's
own abs-max differs from the batch's at the stem.  Rank workers import
nothing of JAX.

Over the batch each sample's arithmetic is the one process's, so the
outputs agree to 1e-5 of their largest value.  Over the height the
instance norms sum each plane's halves apart (~1e-7 from one process), an
int8 value on a rounding boundary then flips by one, and its conv's output
moves by a quantum (~5e-3 here) that the layers after it spread: the
encoder's tap, before the blocks, agrees to 1e-5, the block tap and the
output in their mean to 1e-2 (measured: 5e-5 and 3e-3)."""

import os

import numpy as np
import torch

from cat_tpu_torch.parallel import mesh

torch.set_num_threads(1)

SIZE = 32
TIMEOUT = 180
TAPS = ("encode", "block1")


def _cfg():
    from cat_tpu_torch.core.config import InceptionGeneratorConfig, NormConfig

    return InceptionGeneratorConfig.make(
        ngf=8, channels_reduction_factor=2, kernel_sizes=(1, 3, 5), n_blocks=2,
        norm=NormConfig(kind="instance", affine=True, track_running_stats=False))


def _teacher(sd=None):
    from cat_tpu_torch.models.generator import InceptionGenerator

    gen = InceptionGenerator(_cfg(), init_gain=0.1, packed_blocks=True,
                             generator=torch.Generator().manual_seed(3))
    if sd is not None:
        gen.load_state_dict(sd)
    return gen.eval()


def _calibrate(gen, x):
    from cat_tpu_torch.ops.quant import int8_calibrate

    params = {k: v.detach() for k, v in gen.named_parameters()}
    (y, acts), scales = int8_calibrate(
        lambda p, xx: torch.func.functional_call(gen, p, (xx,), {"train": False, "taps": TAPS}),
        params, x)
    return {"y": y, "acts": acts, "scales": scales}


def _rank_main(device, root, n_spatial):
    import torch.distributed as dist

    from cat_tpu_torch.parallel import collectives
    from cat_tpu_torch.parallel.spatial import rows

    torch.set_num_threads(1)
    collectives.set_layout(n_spatial)
    rank = dist.get_rank()
    inp = torch.load(os.path.join(root, "in.pt"))
    x = inp["x"]
    if n_spatial == 1:
        part = x[rank:rank + 1]
    else:
        start, stop = rows(x.shape[2], rank, n_spatial)
        part = x[:, :, start:stop]
    out = _calibrate(_teacher(inp["sd"]), part)
    out["local_stem_max"] = float(part.abs().amax())
    torch.save(out, os.path.join(root, f"out{n_spatial}_{rank}.pt"))


def test_scales_are_the_global_batchs_over_data_and_height(tmp_path):
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 3, SIZE, SIZE).astype(np.float32))
    x[1] *= 3.0
    gen = _teacher()
    torch.save({"x": x, "sd": gen.state_dict()}, tmp_path / "in.pt")
    for n_spatial in (1, 2):
        mesh.spawn(_rank_main, 2, args=(str(tmp_path), n_spatial), device="cpu",
                   timeout=TIMEOUT)
    one = _calibrate(gen, x)
    assert len(one["scales"]) == 20
    for n_spatial in (1, 2):
        ranks = [torch.load(tmp_path / f"out{n_spatial}_{r}.pt") for r in (0, 1)]
        # without the all-reduce, the ranks' stem scales would differ
        assert ranks[0]["local_stem_max"] != ranks[1]["local_stem_max"]
        for rk in ranks:
            np.testing.assert_allclose(rk["scales"], one["scales"], rtol=1e-6,
                                       err_msg=f"n_spatial {n_spatial}")
        dim = 0 if n_spatial == 1 else 2
        for name in ("y", *TAPS):
            got = torch.cat([rk["y"] if name == "y" else rk["acts"][name] for rk in ranks], dim)
            want = one["y"] if name == "y" else one["acts"][name]
            if n_spatial == 1 or name == "encode":
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                           atol=1e-5 * float(want.abs().max()),
                                           err_msg=f"n_spatial {n_spatial} {name}")
            else:
                gap = float((got - want).abs().mean() / want.abs().mean())
                assert gap < 1e-2, (name, gap)
