"""The train and distill verbs over two gloo processes on the CPU, at toy
size (ngf 8, 3 blocks, crop 32, global batch 4; GauGAN at
tests/test_torch_spade.py's SPADE_TINY, batch 2): ``--num_processes 2``
with ``--process_id`` and ``--coordinator_address``, and ``--n_devices 2``
(ranks spawned by the verb).  Only rank 0 writes the options, the logs and
the checkpoints; both ranks print the same losses; the checkpoints equal a
one-process run's within Adam's 2.5·lr·steps (its ±lr on float32-noise
gradients, tests/test_torch_teacher.py's bound).  The one-process default
creates no process group.

Each group of ranks gets 120 s and is killed past it.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from cat_tpu_torch import entry
from cat_tpu_torch.core.config import InceptionGeneratorConfig, NormConfig
from cat_tpu_torch.models.generator import InceptionGenerator
from cat_tpu_torch.parallel import mesh
from cat_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

LR = 2e-4
TIMEOUT = 120


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 images a side (unaligned), 8 A|B pairs (aligned), and a seeded
    ngf-8 teacher with spread norm scales."""
    root = tmp_path_factory.mktemp("pverb")
    rs = np.random.RandomState(0)
    for side in ("trainA", "trainB", "valA", "valB"):
        os.makedirs(root / "unaligned" / side)
        for i in range(8):
            Image.fromarray(rs.randint(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                root / "unaligned" / side / f"{i}.png")
    for split in ("train", "val"):
        os.makedirs(root / "aligned" / split)
        for i in range(8):
            Image.fromarray(rs.randint(0, 256, (32, 64, 3), dtype=np.uint8)).save(
                root / "aligned" / split / f"{i}.png")
    cfg = InceptionGeneratorConfig.make(
        ngf=8, channels_reduction_factor=2, kernel_sizes=(1, 3, 5), n_blocks=3,
        norm=NormConfig(kind="instance", affine=True, track_running_stats=False))
    g = InceptionGenerator(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in g.named_parameters():
            if p.dim() == 1 and name.endswith("weight"):
                p.copy_(torch.from_numpy(rs.uniform(0.05, 2.0, p.shape).astype(np.float32)))
    ckpt.save_net(str(root / "teacher"), "best", "G", g.state_dict(), cfg)
    from tests.test_torch_spade import write_cityscapes

    write_cityscapes(str(root / "cityscapes"), size=(128, 64))
    return root


def distill_args(root, log_dir, *extra):
    """scripts/cycle_gan/horse2zebra/train_inception_student_2p6B.sh's
    flags, cut to this size (KA on the encoder and block 2)."""
    return ["--dataroot", str(root / "unaligned"), "--dataset_mode", "unaligned",
            "--gan_mode", "lsgan", "--log_dir", str(log_dir),
            "--restore_teacher_G_path", str(root / "teacher" / "best_net_G.pth"),
            "--nepochs", "1", "--nepochs_decay", "0", "--ndf", "8", "--batch_size", "4",
            "--norm_affine", "--norm_affine_D", "--channels_reduction_factor", "2",
            "--kernel_sizes", "1", "3", "5", "--n_blocks", "3", "--lambda_distill", "1.0",
            "--lambda_recon", "5", "--prune_cin_lb", "2", "--target_flops", "6e6",
            "--distill_G_loss_type", "ka", "--load_size", "36", "--crop_size", "32",
            "--num_threads", "2", "--print_freq", "1", "--save_epoch_freq", "1", *extra]


def train_args(root, model, log_dir, *extra):
    """The teacher recipes' flags (pix2pix with tracked batch norm,
    CycleGAN, GauGAN with syncbatch), cut to this size."""
    common = ["--log_dir", str(log_dir), "--ngf", "8", "--ndf", "8", "--n_blocks", "3",
              "--load_size", "36", "--crop_size", "32", "--batch_size", "4", "--nepochs", "1",
              "--nepochs_decay", "0", "--print_freq", "1", "--save_epoch_freq", "1",
              "--num_threads", "2"]
    if model == "pix2pix":
        return ["--model", "pix2pix", "--dataroot", str(root / "aligned"), "--norm", "batch",
                "--norm_track_running_stats", "--load_size", "32", *common, *extra]
    if model == "spade":
        from tests.test_torch_spade import SPADE_TINY

        return [*SPADE_TINY, "--dataroot", str(root / "cityscapes"), "--input_nc", "35",
                "--log_dir", str(log_dir), "--vgg_path", str(root / "absent.pth"), *extra]
    return ["--model", "cycle_gan", "--dataroot", str(root / "unaligned"),
            "--dataset_mode", "unaligned", "--pool_size", "3", *common, *extra]


def _losses(log_dir):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if "loss" in k} for line in f]


def _same_losses(got, want, steps=None):
    """Every step's losses (the first ``steps`` where given) at rtol 1e-5."""
    assert len(got) == len(want) > 0
    for g, w in list(zip(got, want))[:steps]:
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _same_checkpoint(log_a, log_b, net, steps, lr=LR):
    """Parameters within 2.5·lr·steps; running statistics and spectral
    ``u``/``v``, which follow them, at rtol 1e-3 and that atol
    (tests/test_torch_spade_distill.py's bound past step 1)."""
    a = torch.load(os.path.join(log_a, "checkpoints", f"latest_net_{net}.pth"))
    b = torch.load(os.path.join(log_b, "checkpoints", f"latest_net_{net}.pth"))
    assert a.keys() == b.keys()
    for k in a:
        diff = (a[k].float() - b[k].float()).abs()
        if any(s in k for s in ("running", "weight_u", "weight_v")):
            bound = 2.5 * lr * steps + 1e-3 * b[k].float().abs()
        else:
            bound = torch.tensor(2.5 * lr * steps)
        assert bool((diff <= bound).all()), (net, k, float(diff.max()))


@pytest.fixture(scope="module")
def one_process(data, tmp_path_factory):
    """The distill recipe in one process: the reference of the runs below."""
    log_dir = tmp_path_factory.mktemp("w1")
    entry.distill_main(distill_args(data, log_dir), device="cpu")
    assert not dist.is_initialized()
    return str(log_dir)


def _flag_rank(rank, argv, port, out_dir):
    """A rank started on its own, joining through the multi-process flags."""
    import sys

    torch.set_num_threads(1)
    sys.stdout = open(os.path.join(out_dir, f"rank{rank}.txt"), "w")
    entry.distill_main([*argv, "--num_processes", "2", "--process_id", str(rank),
                        "--coordinator_address", f"127.0.0.1:{port}"], device="cpu")
    sys.stdout.flush()


def _run_two(fn, args):
    ctx = mp.start_processes(fn, args=args, nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(max(deadline - time.monotonic(), 0)):
            assert time.monotonic() < deadline, f"the ranks ran past {TIMEOUT} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def test_num_processes_two_ranks_write_once_and_equal_one_process(data, one_process, tmp_path):
    log_dir = tmp_path / "log"
    _run_two(_flag_rank, (distill_args(data, log_dir), mesh.free_port(), str(tmp_path)))
    with open(log_dir / "opt.txt") as f:
        assert f.read().count("----------------- Options ---------------") == 1
    with open(log_dir / "log.txt") as f:
        log = f.read()
    assert log.count("(epoch: 1, iters: 1,") == 1
    assert os.path.exists(log_dir / "student_config.json")
    _same_losses(_losses(log_dir), _losses(one_process))
    _same_checkpoint(str(log_dir), one_process, "G", 2)
    _same_checkpoint(str(log_dir), one_process, "D", 2)
    printed = []
    for r in (0, 1):
        with open(tmp_path / f"rank{r}.txt") as f:
            printed.append([re.sub(r"time: [0-9.]+", "", line)
                            for line in f if line.startswith("(epoch")])
    assert len(printed[0]) == 2 and printed[0] == printed[1]


def test_n_devices_spawns_two_ranks_on_the_cpu(data, one_process, tmp_path):
    assert entry.distill_main(distill_args(data, tmp_path, "--n_devices", "2"),
                              device="cpu") is None
    assert not dist.is_initialized()
    _same_losses(_losses(tmp_path), _losses(one_process))
    _same_checkpoint(str(tmp_path), one_process, "G", 2)


@pytest.mark.parametrize("model, nets, loss_steps", [
    ("pix2pix", ("G", "D"), 2), ("cycle_gan", ("G_A", "G_B", "D_A", "D_B"), 2),
    # GauGAN's hinge losses after its first TTUR step move by ~2e-4 with
    # Adam's ±lr on D's near-zero gradients (the first convs' biases, where
    # the fake and the real term nearly cancel), which two half-batch sums
    # round otherwise than one sum: step 2 is held by the checkpoints' bound
    ("spade", ("G", "D"), 1)])
def test_train_verb_over_two_ranks_equals_one_process(data, tmp_path, model, nets, loss_steps):
    """pix2pix with tracked batch norm (synchronised statistics), CycleGAN
    with its pools over the global batch, GauGAN with syncbatch at one row a
    rank: two steps, then the losses and every checkpoint (running
    statistics at 1e-5; GauGAN's D at its TTUR rate, 2·lr)."""
    entry.train_main(train_args(data, model, tmp_path / "w1"), device="cpu")
    entry.train_main(train_args(data, model, tmp_path / "w2", "--n_devices", "2"), device="cpu")
    _same_losses(_losses(tmp_path / "w2"), _losses(tmp_path / "w1"), loss_steps)
    for net in nets:
        lr = 2 * LR if model == "spade" and net == "D" else LR
        _same_checkpoint(str(tmp_path / "w2"), str(tmp_path / "w1"), net, 2, lr)


def test_n_devices_beyond_the_visible_cards_raises(data, tmp_path):
    n = torch.cuda.device_count() + 2
    with pytest.raises(ValueError, match=f"requested {n} devices but only "
                                         f"{n - 2} available"):
        entry.distill_main(distill_args(data, tmp_path, "--n_devices", str(n)))
    assert not os.path.exists(tmp_path / "opt.txt")


def test_multihost_without_flags_or_launcher_raises(data, tmp_path, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--coordinator_address, --num_processes, "
                                         "--process_id not given"):
        entry.distill_main(distill_args(data, tmp_path, "--multihost", "1"), device="cpu")
    assert not dist.is_initialized()


def test_one_process_by_default(data, one_process):
    """--n_devices 1: no group, the whole batch, every file written."""
    from cat_tpu_torch import cli

    opt = cli.distill_parser().parse_args(distill_args(data, "unused"))
    assert entry.init_parallel(opt, "cpu") == (True, None, torch.device("cpu"))
    assert not dist.is_initialized()
    for name in ("opt.txt", "log.txt", "student_config.json", "checkpoints"):
        assert os.path.exists(os.path.join(one_process, name))
