"""Cityscapes mIoU in the port against the JAX package (CPU, float32, tiny
sizes, inputs made with numpy from a seed): the confusion matrix and IoU,
the DRN judge against the reference fixture and against the JAX judge, the
bilinear resize, ``get_miou``, ``MIoUEvaluator`` and the entry's factory."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cat_tpu.data import datasets as jds
from cat_tpu.data import transforms as jtf
from cat_tpu.metrics import drn as jdrn
from cat_tpu.metrics import miou as jmiou
from cat_tpu.train.evaluation import MIoUEvaluator as JMIoU
from cat_tpu_torch import entry
from cat_tpu_torch.data import datasets as tds
from cat_tpu_torch.data import transforms as ttf
from cat_tpu_torch.metrics import drn, miou
from cat_tpu_torch.train.evaluation import MIoUEvaluator
from cat_tpu_torch.utils.jax_import import drnseg_state_dict
from tests.conftest import fast_init

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "drn_fixture.npz")
TINY_LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)
TINY_CHANNELS = (4, 8, 8, 8, 8, 8, 8, 8)
CLASSES = 4
H, W = 32, 64  # the labels' and the judge's size


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def fixture():
    data = np.load(FIXTURE)
    sd = {k[3:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd/")}
    layers = tuple(int(v) for v in data["layers"])
    channels = tuple(int(v) for v in data["channels"])
    return sd, layers, channels, data["x"], data["ref"]


@pytest.fixture(scope="module")
def tiny_judge(tmp_path_factory):
    """A tiny random JAX DRNSeg, written by the JAX package's save_drnseg
    (.msgpack + .json), with the port's judge read from that file."""
    path = str(tmp_path_factory.mktemp("drn") / "drn_tiny.msgpack")
    model = jdrn.DRNSeg(classes=CLASSES, layers=TINY_LAYERS, channels=TINY_CHANNELS)
    variables = fast_init(model, jnp.zeros((1, H, W, 3)), seed=3)
    jdrn.save_drnseg(path, model, variables)
    return {"path": path, "jax": jdrn.load_drnseg(path),
            "port": drn.load_drnseg(path, device="cpu")}


@pytest.mark.parametrize("n", [5, 19])
def test_fast_hist_and_iou_match_jax(rng, n):
    """Void labels (255) and labels past n are dropped; the tensor histogram
    equals the numpy one count for count; IoU, mean and median equal."""
    pred = rng.randint(0, n, (3, 17, 23))
    label = rng.randint(0, n, (3, 17, 23))
    label[rng.rand(*label.shape) < 0.2] = 255
    label[0, 0, :5] = n
    want = jmiou.fast_hist(pred, label, n)
    np.testing.assert_array_equal(miou.fast_hist(pred, label, n), want)
    got = miou.fast_hist(torch.from_numpy(pred), torch.from_numpy(label.astype(np.uint8)), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    pairs = [(pred[i], label[i]) for i in range(3)]
    hist = jmiou.accumulate_hist(pairs, n)
    np.testing.assert_array_equal(miou.accumulate_hist(pairs, n), hist)
    np.testing.assert_array_equal(miou.per_class_iou(hist), jmiou.per_class_iou(hist))
    assert miou.mean_iou(hist) == jmiou.mean_iou(hist)
    assert miou.median_iou(hist) == jmiou.median_iou(hist)
    x = rng.rand(2, 3, 4, 5)
    np.testing.assert_allclose(miou.normalize_for_drn(x),
                               jmiou.normalize_for_drn(x.transpose(0, 2, 3, 1))
                               .transpose(0, 3, 1, 2), rtol=1e-12)


def test_drnseg_matches_the_reference_fixture(fixture):
    """The reference checkpoint's layout loads strictly (its
    num_batches_tracked included); the output is the reference DRNSeg's
    after the fixed bilinear x8, to rel < 1e-5 as tests/test_drn.py holds
    the JAX judge."""
    sd, layers, channels, x, ref = fixture
    model = drn.DRNSeg(5, layers, channels)
    model.load_state_dict(drn.drnseg_layout({f"module.{k}": v for k, v in sd.items()}))
    out = _nhwc(model(torch.from_numpy(x)))
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


def test_drnseg_matches_jax_both_ways(fixture, tiny_judge, rng):
    """The port's state_dict through ``convert_torch_drnseg`` gives the JAX
    judge's logits, upsampled or not; a JAX-written judge (.msgpack) gives
    the port the JAX judge's logits."""
    sd, layers, channels, _, _ = fixture
    model = drn.DRNSeg(5, layers, channels)
    model.load_state_dict(sd)
    x = rng.randn(2, 3, 24, 40).astype(np.float32)
    variables = jdrn.convert_torch_drnseg({k: v.numpy() for k, v in model.state_dict().items()},
                                          classes=5, layers=layers)
    jm = jdrn.DRNSeg(classes=5, layers=layers, channels=channels)
    for up in (True, False):
        want = np.asarray(jm.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), upsample=up))
        got = _nhwc(model(torch.from_numpy(x), upsample=up))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jmodel, jvars = tiny_judge["jax"]
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x.transpose(0, 2, 3, 1))))
    got = _nhwc(tiny_judge["port"](torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # and the carried state_dict goes back to the same JAX tree
    back = jdrn.convert_torch_drnseg(
        {k: v.numpy() for k, v in drnseg_state_dict(jvars, TINY_LAYERS).items()},
        classes=CLASSES, layers=TINY_LAYERS)
    flat = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat) == len(jax.tree_util.tree_leaves(jvars))
    for path, leaf in flat:
        node = jvars
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(leaf, np.asarray(node))


@pytest.mark.parametrize("src,dst", [((8, 12), (32, 48)), ((5, 7), (16, 64)), ((8, 12), (8, 12)),
                                     ((37, 53), (16, 20)), ((37, 53), (12, 53))])
def test_bilinear_resize_is_jax_image_resize(rng, src, dst):
    """``F.interpolate(mode="bilinear", align_corners=False,
    antialias=False)`` is ``jax.image.resize(..., "bilinear")`` when it
    upsamples (half-pixel centres; jax antialiases only what it shrinks),
    and with ``antialias=True`` when it shrinks."""
    x = rng.randn(2, 3, *src).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, *dst, 3), "bilinear")
    got = _nhwc(drn.resize_bilinear(torch.from_numpy(x), dst))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_get_miou_matches_jax(tiny_judge, rng):
    """Fakes at half the labels' size, upscaled before the judge; labels
    with void pixels: the same mIoU to its two decimals."""
    fakes = rng.uniform(-1, 1, (5, 3, H // 2, W // 2)).astype(np.float32)
    labels = [rng.randint(0, CLASSES, (H, W)).astype(np.uint8) for _ in range(5)]
    labels[0][:4] = 255
    jmodel, jvars = tiny_judge["jax"]
    want = jdrn.get_miou(fakes.transpose(0, 2, 3, 1), labels, jmodel, jvars, batch_size=2,
                         target_hw=(H, W))
    got = drn.get_miou(torch.from_numpy(fakes), labels, tiny_judge["port"], batch_size=2,
                       target_hw=(H, W))
    assert isinstance(got, float) and got == want


def _cityscapes_fixture(root, n=4, drop_last_row=False):
    """Aligned val composites named like leftImg8bit photos, labelId maps,
    and a table pairing them (tests/test_miou_evaluator.py's layout)."""
    lab_dir = root / "gtFine" / "val" / "synth"
    pair_dir = root / "pairs" / "val"
    lab_dir.mkdir(parents=True)
    pair_dir.mkdir(parents=True)
    rs = np.random.RandomState(0)
    rows = []
    for i in range(n):
        stem = f"synth_{i:06d}_000019"
        Image.fromarray(rs.randint(0, CLASSES, (H, W)).astype(np.uint8)).save(
            lab_dir / f"{stem}_gtFine_labelIds.png")
        Image.fromarray(rs.randint(0, 255, (H, 2 * W, 3)).astype(np.uint8)).save(
            pair_dir / f"{stem}_leftImg8bit.png")
        rows.append(f"{i} gtFine/val/synth/{stem}_gtFine_labelIds.png "
                    f"leftImg8bit/val/synth/{stem}_leftImg8bit.png")
    table = root / "table.txt"
    table.write_text("\n".join(rows[:-1] if drop_last_row else rows) + "\n")
    return table


@pytest.mark.parametrize("drop_last_row", [False, True])
def test_miou_evaluator_matches_jax(tmp_path, tiny_judge, drop_last_row):
    """The same sweep through both evaluators: the same metrics and best
    flags over two calls (equal is no improvement); a sample without a table
    row is generated and left out of the score."""
    table = _cityscapes_fixture(tmp_path, drop_last_row=drop_last_row)
    spec = dict(preprocess="none", load_size=W, crop_size=W, no_flip=True)
    seen = []

    def port_generate(x):
        seen.append(x.shape[0])
        return torch.tanh(0.7 * x + 0.1)

    ev = MIoUEvaluator(port_generate, tds.create_eval_dataloader(
        "aligned", str(tmp_path / "pairs"), 2, ttf.TransformSpec(**spec), "BtoA"),
        tiny_judge["port"], str(table), data_dir=str(tmp_path), batch_size=2, device="cpu")
    jmodel, jvars = tiny_judge["jax"]
    jev = JMIoU(lambda x: np.tanh(0.7 * np.asarray(x) + 0.1), jds.create_eval_dataloader(
        "aligned", str(tmp_path / "pairs"), 2, jtf.TransformSpec(**spec), "BtoA"),
        jmodel, jvars, str(table), data_dir=str(tmp_path), batch_size=2)
    for step in ("0", "1"):
        got, want = ev(step), jev(step)
        assert set(got[0]) == {"metric/mIoU", "metric/mIoU-mean", "metric/mIoU-best"}
        assert got[0] == want[0]
        assert bool(got[1].get("is_best")) == bool(want[1].get("is_best")) == (step == "0")
    assert sum(seen) == 8


def test_make_miou_evaluator_guards_and_warnings(tmp_path, tiny_judge, capsys):
    """A judge where the JAX package makes one; None for AtoB or a dataroot
    not naming cityscapes; the JAX package's warnings, word for word, when
    the DRN weights or the table are absent."""
    table = _cityscapes_fixture(tmp_path)
    opt = argparse.Namespace(dataroot=str(tmp_path / "cityscapes_pairs"), direction="BtoA",
                             drn_path=tiny_judge["path"], table_path=str(table),
                             cityscapes_path=str(tmp_path), eval_batch_size=2)
    ev = entry.make_miou_evaluator(opt, lambda x: x, [], "cpu")
    assert isinstance(ev, MIoUEvaluator) and ev.drn_model.classes == CLASSES
    assert entry.make_miou_evaluator(argparse.Namespace(**{**vars(opt), "direction": "AtoB"}),
                                     None, None, "cpu") is None
    assert entry.make_miou_evaluator(argparse.Namespace(**{**vars(opt), "dataroot": "maps"}),
                                     None, None, "cpu") is None
    capsys.readouterr()
    for key, what in (("drn_path", "DRN weights"), ("table_path", "table file")):
        missing = argparse.Namespace(**{**vars(opt), key: str(tmp_path / "absent")})
        assert entry.make_miou_evaluator(missing, None, None, "cpu") is None
        assert (f"WARNING: {what} not found at {str(tmp_path / 'absent')!r}; mIoU disabled."
                in capsys.readouterr().out)


def test_random_full_spec_judge_loads_strictly(tmp_path):
    """A seeded DRN-D-105 in the reference checkpoint's layout (its
    ``up.weight`` and a ``module.`` prefix included) loads strictly; a
    missing tensor fails; the JAX package reads the same file."""
    sd = drn.random_drnseg_state_dict(seed=1)
    assert "up.weight" in sd and "base.5.22.bn3.running_var" in sd
    path = str(tmp_path / "drn.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    model = drn.load_drnseg(path, device="cpu")
    assert torch.equal(model.base[5][22].conv2.weight, sd["base.5.22.conv2.weight"])
    assert torch.equal(model.up_kernel, sd["up.weight"])
    _, variables = jdrn.load_drnseg(path)
    np.testing.assert_array_equal(variables["params"]["seg"]["bias"], sd["seg.bias"].numpy())
    del sd["base.4.3.bn2.weight"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        drn.load_drnseg(path, device="cpu")


# ---------------------------------------------------------------------------
# The pix2pix Cityscapes recipes through the verbs
# ---------------------------------------------------------------------------


def write_miou_inputs(root, names, size=32, seed=0):
    """trainId maps (``size`` square, ids 0-3 and some void) under
    ``root/cityscapes-origin`` and a table pairing each sample name with its
    map; returns (table path, cityscapes_path)."""
    origin = root / "cityscapes-origin"
    os.makedirs(origin / "gtFine" / "val", exist_ok=True)
    rs = np.random.RandomState(seed)
    rows = []
    for name in names:
        rel = f"gtFine/val/{name}_gtFine_trainIds.png"
        label = rs.randint(0, CLASSES, (size, size)).astype(np.uint8)
        label[:2] = 255
        Image.fromarray(label).save(origin / rel)
        rows.append(f"{name} {rel} leftImg8bit/val/{name}_leftImg8bit.png")
    (root / "table.txt").write_text("\n".join(rows) + "\n")
    return str(root / "table.txt"), str(origin)


@pytest.fixture(scope="module")
def pix2pix_cityscapes(tmp_path_factory, tiny_judge):
    """Aligned A|B PNGs under a dataroot naming cityscapes (4 train, 4 val),
    and the mIoU inputs of the val samples."""
    root = tmp_path_factory.mktemp("p2p")
    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        os.makedirs(root / "cityscapes" / split)
        for i in range(4):
            Image.fromarray(rs.randint(0, 256, (32, 64, 3), dtype=np.uint8)).save(
                root / "cityscapes" / split / f"{i}.png")
    table, origin = write_miou_inputs(root, [str(i) for i in range(4)])
    return {"root": root, "miou": ["--dataroot", str(root / "cityscapes"), "--direction", "BtoA",
                                   "--drn_path", tiny_judge["path"], "--table_path", table,
                                   "--cityscapes_path", origin, "--inception_path",
                                   str(root / "absent.pth"), "--eval_batch_size", "2"]}


# scripts/pix2pix/cityscapes/*_inception_*.sh, cut to crop 32, ngf 4-8, 3 blocks
P2P_NORMS = ["--norm", "batch", "--norm_affine", "--norm_affine_D", "--norm_track_running_stats",
             "--channels_reduction_factor", "2", "--kernel_sizes", "1", "3", "5", "--n_blocks",
             "3", "--load_size", "32", "--crop_size", "32", "--num_threads", "2"]
P2P_LOOP = ["--batch_size", "2", "--nepochs", "1", "--nepochs_decay", "0", "--print_freq", "1",
            "--save_epoch_freq", "1", "--serial_batches", "--no_flip"]


def _mious(log_dir):
    import json

    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [r["metric/mIoU"] for r in map(json.loads, f) if "metric/mIoU" in r]


def test_pix2pix_cityscapes_recipes_report_miou(pix2pix_cityscapes, tmp_path):
    """The teacher recipe (train), the 5.6e9 student recipe (distill, KA,
    from the teacher's best G and D) and the evaluate recipe (profile) each
    report mIoU of the generated photos; train and distill tag the best."""
    w = pix2pix_cityscapes
    teacher = tmp_path / "teacher"
    entry.train_main([*w["miou"], "--model", "pix2pix", "--log_dir", str(teacher), "--ngf", "8",
                      "--ndf", "8", *P2P_NORMS, *P2P_LOOP], device="cpu")
    assert len(_mious(teacher)) == 2
    best_g = str(teacher / "checkpoints" / "best_net_G.pth")
    assert os.path.exists(best_g)
    student = tmp_path / "student"
    entry.distill_main([*w["miou"], "--distiller", "inception", "--log_dir", str(student),
                        "--restore_teacher_G_path", best_g, "--restore_pretrained_G_path",
                        best_g, "--restore_D_path", str(teacher / "checkpoints" / "best_net_D.pth"),
                        "--teacher_ngf", "8", "--student_ngf", "4", "--ndf", "8",
                        "--lambda_distill", "0.5", "--prune_cin_lb", "2", "--target_flops",
                        "6e6", "--distill_G_loss_type", "ka", *P2P_NORMS, *P2P_LOOP],
                       device="cpu")
    assert len(_mious(student)) == 2
    assert os.path.exists(student / "checkpoints" / "best_net_G.pth")
    prof = entry.profile_main([*w["miou"], "--distiller", "inception", "--log_dir",
                               str(tmp_path / "eval"), "--restore_teacher_G_path", best_g,
                               "--pretrained_student_G_path",
                               str(student / "checkpoints" / "best_net_G.pth"), "--prune_cin_lb",
                               "2", "--target_flops", "6e6", "--times", "2", *P2P_NORMS],
                              device="cpu")
    assert 0.0 <= prof["metrics"]["metric/mIoU"] <= 100.0
    assert "metric/fid" not in prof["metrics"]
    no_miou = entry.profile_main([*w["miou"], "--distiller", "inception", "--log_dir",
                                  str(tmp_path / "eval2"), "--restore_teacher_G_path", best_g,
                                  "--prune_cin_lb", "2", "--target_flops", "6e6", "--times", "1",
                                  "--no_mIoU", *P2P_NORMS], device="cpu")
    assert no_miou["metrics"] == {}
