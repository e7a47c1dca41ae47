"""The train and distill verbs with ``--n_spatial`` (image height split over
ranks) on the CPU, at toy size (ngf 8, 3 blocks, crop 32, global batch 4;
``tests/test_torch_parallel_verb.py``'s data and flags; the GauGAN verbs at
``tests/test_torch_spade.py``'s SPADE_TINY, 64 x 32, batch 2):
``--n_spatial 2`` spawns two gloo ranks that each hold half of every
image's rows, and ``--n_devices 2 --n_spatial 2`` four (a 2 x 2 grid).
Each run logs the losses of one process (rtol 1e-5; CycleGAN's and
GauGAN's at step 1, see below) and writes checkpoints within Adam's
2.5·lr·steps of its.  The refusal: ``--n_spatial`` with ``--multihost`` or
``--num_processes`` (the JAX package's text), for both families.
"""

import os

import pytest
import torch
import torch.distributed as dist

from cat_tpu_torch import entry
from tests.test_torch_parallel_verb import (LR, _losses, _same_checkpoint, _same_losses,  # noqa: F401
                                            data, distill_args, one_process, train_args)

torch.set_num_threads(1)


OPTIONS = ["--distill_G_loss_type", "mse", "--gan_mode", "vanilla", "--fused_norms"]


@pytest.mark.parametrize("flags", [["--n_spatial", "2"],
                                   ["--n_devices", "2", "--n_spatial", "2"],
                                   ["--n_spatial", "2", "--on_device_data", "1"],
                                   ["--n_spatial", "2", *OPTIONS]])
def test_distill_verb_with_a_split_height_equals_one_process(data, one_process, tmp_path,
                                                              flags):
    """The horse2zebra student recipe cut to toy size, its two steps' losses
    and G against one process's; with ``--on_device_data`` against one
    process with the bank (every rank draws the global batch and keeps its
    rows); with mse adaptors, the vanilla GAN loss and the fused norm (its
    split-plane passes) against one process with the same options."""
    want = one_process
    extra = [f for f in flags if f not in ("--n_spatial", "--n_devices", "2")]
    if extra:
        want = str(tmp_path / "w1")
        entry.distill_main(distill_args(data, want, *extra), device="cpu")
    assert entry.distill_main(distill_args(data, tmp_path / "w2", *flags), device="cpu") is None
    assert not dist.is_initialized()
    _same_losses(_losses(tmp_path / "w2"), _losses(want))
    _same_checkpoint(str(tmp_path / "w2"), want, "G", 2)
    _same_checkpoint(str(tmp_path / "w2"), want, "D", 2)


@pytest.mark.parametrize("model, nets, loss_steps", [
    ("pix2pix", ("G", "D"), 2),
    # CycleGAN's instance norms take float32 statistics E[x²] - mean² (the
    # JAX package's numerics), whose cancellation leaves the gradients of
    # the weights before them ~1e-3 relative apart when the planes' sums are
    # split over ranks (equal to 1e-13 with float64 statistics); Adam's first
    # step turns the elements near zero into ±lr, which moves step 2's losses
    # by up to ~2e-3: step 2 is held by the checkpoints' bound
    ("cycle_gan", ("G_A", "G_B", "D_A", "D_B"), 1),
    # the same under --remat 1: the recompute runs the exchanges again
    ("cycle_gan --remat 1", ("G_A", "G_B", "D_A", "D_B"), 1)])
def test_train_verb_with_a_split_height_equals_one_process(data, tmp_path, model, nets,
                                                           loss_steps):
    """pix2pix with tracked batch norm (statistics over the world, counts
    over the spatial axis) and CycleGAN (its pools of whole images), also
    under --remat 1: two steps, the losses and every checkpoint against one
    process's."""
    model, *extra = model.split()
    entry.train_main(train_args(data, model, tmp_path / "w1", *extra), device="cpu")
    entry.train_main(train_args(data, model, tmp_path / "w2", *extra, "--n_spatial", "2"),
                     device="cpu")
    _same_losses(_losses(tmp_path / "w2"), _losses(tmp_path / "w1"), loss_steps)
    for net in nets:
        _same_checkpoint(str(tmp_path / "w2"), str(tmp_path / "w1"), net, 2)


@pytest.fixture(scope="module")
def spade_files(data):
    """A seeded GauGAN teacher (35 labels + dontcare + edges, ngf 4, norm
    scales spread so that the shrink has signal; a 1-row latent at 64 x 32,
    so that the second of two spatial ranks owns none of it) and a D of the
    SPADE defaults' four layers, saved beside ``data``'s Cityscapes-layout
    images; the student recipe's target, half the teacher's MACs."""
    import numpy as np

    from cat_tpu_torch.compress.spade import profile_spade_generator
    from cat_tpu_torch.core.spade_config import MultiscaleDiscriminatorConfig, SPADEGeneratorConfig
    from cat_tpu_torch.models.spade import MultiscaleDiscriminator, SPADEGenerator
    from cat_tpu_torch.utils import checkpoint as ckpt

    cfg = SPADEGeneratorConfig.make(semantic_nc=37, ngf=4, channels_reduction_factor=4,
                                    kernel_sizes=(1, 3), num_upsampling_layers="normal",
                                    crop_size=64, aspect_ratio=2.0)
    gen = SPADEGenerator(cfg, "xavier", generator=torch.Generator().manual_seed(3))
    rs = np.random.RandomState(3)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(torch.from_numpy(rs.uniform(0.05, 2.0, p.shape).astype(np.float32)))
    d_cfg = MultiscaleDiscriminatorConfig(input_nc=40, ndf=4, n_layers=4, num_D=2)
    disc = MultiscaleDiscriminator(d_cfg, "xavier", generator=torch.Generator().manual_seed(4))
    return {"G": ckpt.save_net(str(data / "spade"), "teacher", "G", gen.state_dict(), cfg),
            "D": ckpt.save_net(str(data / "spade"), "teacher", "D", disc.state_dict(), d_cfg),
            "target": str(0.5 * profile_spade_generator(cfg, 32, 64).macs)}


def spade_distill_args(data, files, log_dir, *extra):
    """scripts/gaugan/cityscapes/train_inception_student_5p6B.sh's flags cut
    to this size: the teacher's G as teacher and pretrained G, its D, KA on
    head_0, G_middle_1 and up_1."""
    return [*train_args(data, "spade", log_dir), "--distiller", "spade",
            "--restore_teacher_G_path", files["G"], "--restore_pretrained_G_path", files["G"],
            "--restore_D_path", files["D"], "--target_flops", files["target"],
            "--distill_G_loss_type", "ka", "--lambda_distill", "0.5", *extra]


@pytest.mark.parametrize("verb", ["train", "distill"])
def test_spade_verbs_with_a_split_height_equal_one_process(data, spade_files, tmp_path, verb):
    """``train --model spade`` (syncbatch G, spectral multiscale D, hinge)
    and ``distill --distiller spade`` (the 5p6B recipe: KA on three taps,
    the 1-row head_0 leaving the second rank no rows) with ``--n_spatial
    2``: step 1's losses at rtol 1e-5 (step 2 moves with Adam's ±lr on
    D's near-zero gradients, as over two data ranks) and the checkpoints
    within Adam's 2.5·lr·steps of one process's at each net's TTUR rate."""
    if verb == "train":
        main, args, nets = entry.train_main, lambda d, *e: train_args(data, "spade", d, *e), "GD"
    else:
        main, nets = entry.distill_main, "G"
        args = lambda d, *e: spade_distill_args(data, spade_files, d, *e)  # noqa: E731
    main(args(tmp_path / "w1"), device="cpu")
    assert main(args(tmp_path / "w2", "--n_spatial", "2"), device="cpu") is None
    assert not dist.is_initialized()
    _same_losses(_losses(tmp_path / "w2"), _losses(tmp_path / "w1"), 1)
    for net in nets:
        _same_checkpoint(str(tmp_path / "w2"), str(tmp_path / "w1"), net, 2,
                         2 * LR if net == "D" else LR)


@pytest.mark.parametrize("verb", ["distill", "train"])
def test_spade_n_spatial_with_num_processes_raises_the_jax_packages_text(data, spade_files,
                                                                         tmp_path, verb):
    """As ``cat_tpu/entry.py:103-109``, for the GauGAN verbs too."""
    argv = (spade_distill_args(data, spade_files, tmp_path) if verb == "distill"
            else train_args(data, "spade", tmp_path))
    main = entry.distill_main if verb == "distill" else entry.train_main
    with pytest.raises(SystemExit, match="--n_spatial > 1 is not supported together with "
                                         "--multihost"):
        main([*argv, "--n_spatial", "2", "--num_processes", "2", "--process_id", "0",
              "--coordinator_address", "127.0.0.1:1"], device="cpu")
    assert not dist.is_initialized()
    assert not os.path.exists(tmp_path / "opt.txt")


@pytest.mark.parametrize("flags", [["--multihost", "1"],
                                   ["--num_processes", "2", "--process_id", "0",
                                    "--coordinator_address", "127.0.0.1:1"]])
@pytest.mark.parametrize("verb", ["distill", "train"])
def test_n_spatial_with_multihost_raises_the_jax_packages_text(data, tmp_path, flags, verb):
    """As ``cat_tpu/entry.py:103-109``: the spatial axis is for the ranks of
    one host; nothing is written and no group is joined."""
    argv = (distill_args(data, tmp_path) if verb == "distill"
            else train_args(data, "pix2pix", tmp_path))
    main = entry.distill_main if verb == "distill" else entry.train_main
    with pytest.raises(SystemExit, match="--n_spatial > 1 is not supported together with "
                                         "--multihost"):
        main([*argv, "--n_spatial", "2", *flags], device="cpu")
    assert not dist.is_initialized()
    assert not os.path.exists(tmp_path / "opt.txt")


def test_rank_count_is_n_devices_times_n_spatial():
    """k·S ranks; --n_devices 0 is the visible cards divided by S; more
    ranks than cards raise with the JAX package's text; the CPU needs a
    count."""
    from cat_tpu_torch.parallel import mesh

    assert mesh.n_ranks(2, "cpu", 2) == 4 and mesh.n_ranks(1, "cpu", 3) == 3
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {2 * (n + 1)} devices but only {n} "
                                         "available"):
        mesh.n_ranks(n + 1, None, 2)
    with pytest.raises(ValueError, match="ranks on the CPU need a count"):
        mesh.n_ranks(0, "cpu", 2)
    with pytest.raises(ValueError, match="--n_spatial must be at least 1"):
        mesh.n_ranks(1, "cpu", 0)
