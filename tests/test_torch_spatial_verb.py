"""The train and distill verbs with ``--n_spatial`` (image height split over
ranks) on the CPU, at toy size (ngf 8, 3 blocks, crop 32, global batch 4;
``tests/test_torch_parallel_verb.py``'s data and flags): ``--n_spatial 2``
spawns two gloo ranks that each hold half of every image's rows, and
``--n_devices 2 --n_spatial 2`` four (a 2 x 2 grid).  Each run logs the
losses of one process (rtol 1e-5; CycleGAN's at step 1, see below) and
writes checkpoints within Adam's 2.5·lr·steps of its.  The refusals: ``--n_spatial`` with ``--multihost`` or
``--num_processes`` (the JAX package's text), and the SPADE family
(``tests/test_torch_parallel_verb.py::test_n_spatial_raises_naming_item_16b``).
"""

import os

import pytest
import torch
import torch.distributed as dist

from cat_tpu_torch import entry
from tests.test_torch_parallel_verb import (_losses, _same_checkpoint, _same_losses, data,  # noqa: F401
                                            distill_args, one_process, train_args)

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
