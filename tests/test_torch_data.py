"""The port's data path against the JAX package's: transforms, datasets and
loader batches from the same folder and seed, the copy to the device, and
the device-resident bank (CPU; images written with PIL from a seed)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cat_tpu.data import datasets as jds
from cat_tpu.data import transforms as jtf
from cat_tpu.data.device_data import _sample_side as jax_sample_side
from cat_tpu.data.device_data import stack_resized_uint8 as jax_stack_resized_uint8
from cat_tpu.data.loader import DataLoader as JLoader
from cat_tpu_torch.data import datasets as tds
from cat_tpu_torch.data import transforms as ttf
from cat_tpu_torch.data.device_data import (DeviceData, DeviceDataLoader, draw, sample_side,
                                            stack_resized_uint8)
from cat_tpu_torch.data.loader import DataLoader, device_prefetch

torch.set_num_threads(1)


def write_images(directory, n, size=(40, 36), seed=0):
    os.makedirs(directory, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
            os.path.join(directory, f"img_{i}.png"))


@pytest.fixture
def unaligned(tmp_path):
    write_images(tmp_path / "trainA", 6, seed=1)
    write_images(tmp_path / "trainB", 5, seed=2)
    return str(tmp_path)


@pytest.mark.parametrize("preprocess", ["resize_and_crop", "crop", "scale_width_and_crop",
                                        "none"])
def test_transforms_give_the_jax_package_pixels(tmp_path, preprocess):
    """The same file, seed and spec: bit-identical pixels (CHW here)."""
    write_images(tmp_path, 1, size=(48, 40))
    img = Image.open(tmp_path / "img_0.png")
    kw = dict(preprocess=preprocess, load_size=44, crop_size=32)
    import random

    for seed in range(4):
        jp = jtf.get_params(jtf.TransformSpec(**kw), img.size, random.Random(seed))
        tp = ttf.get_params(ttf.TransformSpec(**kw), img.size, random.Random(seed))
        assert (tp.crop_pos, tp.flip) == (jp.crop_pos, jp.flip)
        ref = jtf.apply_transform(img, jtf.TransformSpec(**kw), jp)
        got = ttf.chw(ttf.apply_transform(img, ttf.TransformSpec(**kw), tp))
        np.testing.assert_array_equal(got, ref.transpose(2, 0, 1))


def _same_batches(got, ref):
    assert len(got) == len(ref)
    for bg, br in zip(got, ref):
        assert bg.keys() == br.keys()
        for k in br:
            if isinstance(br[k], np.ndarray):
                assert isinstance(bg[k], torch.Tensor) and bg[k].is_contiguous()
                np.testing.assert_array_equal(bg[k].numpy(), br[k].transpose(0, 3, 1, 2),
                                              err_msg=k)
            else:
                assert bg[k] == br[k]


@pytest.mark.parametrize("mode,workers", [("thread", 0), ("thread", 3), ("process", 2)])
def test_unaligned_loader_gives_the_jax_package_batches(unaligned, mode, workers):
    """Same folder and seed: the same B pairing, crops, flips and shuffle
    over two epochs, whatever the backend (NCHW tensors here, NHWC numpy
    there)."""
    spec = dict(preprocess="resize_and_crop", load_size=36, crop_size=32)

    def stream(mod, loader_cls, tspec, **kw):
        ds = mod.UnalignedDataset(unaligned, "train", tspec(**spec), seed=3)
        loader = loader_cls(ds, 2, shuffle=True, seed=9, drop_last=True, **kw)
        out = [b for _ in range(2) for b in loader]
        loader.close()
        return out

    ref = stream(jds, JLoader, jtf.TransformSpec, num_workers=0)
    got = stream(tds, DataLoader, ttf.TransformSpec, num_workers=workers, worker_mode=mode)
    _same_batches(got, ref)


def test_aligned_and_eval_loaders_give_the_jax_package_batches(tmp_path):
    root = tmp_path / "train"
    write_images(root, 3, size=(64, 30), seed=4)
    write_images(tmp_path / "valA", 2, seed=5)
    spec = dict(preprocess="resize_and_crop", load_size=36, crop_size=32)
    for direction in ("AtoB", "BtoA"):
        ref = list(jds.create_dataloader("aligned", str(tmp_path), 2, jtf.TransformSpec(**spec),
                                         direction=direction, seed=1, num_workers=0))
        got = list(tds.create_dataloader("aligned", str(tmp_path), 2, ttf.TransformSpec(**spec),
                                         direction=direction, seed=1, num_workers=2))
        _same_batches(got, ref)
    ref = list(jds.create_eval_dataloader("unaligned", str(tmp_path), 1, jtf.TransformSpec(**spec)))
    got = list(tds.create_eval_dataloader("unaligned", str(tmp_path), 1, ttf.TransformSpec(**spec)))
    _same_batches(got, ref)
    assert "B" not in got[0]


def test_make_dataset_natural_sort_and_max_size(tmp_path):
    for name in ("a10.png", "a2.png", "a1.png", "b.txt"):
        (tmp_path / name).write_bytes(b"")
    assert tds.natural_sort(["a10.png", "a2.png", "a1.png"]) == ["a1.png", "a2.png", "a10.png"]
    assert tds.make_dataset(str(tmp_path)) == jds.make_dataset(str(tmp_path))
    assert tds.make_dataset(str(tmp_path), 2) == jds.make_dataset(str(tmp_path), 2)


def test_loader_drop_last_and_unported_backend(tmp_path):
    """drop_last; the native backend runs, and on a dataset without a native
    path it gives the thread backend's batches; an unknown backend raises."""
    write_images(tmp_path, 5)
    ds = tds.SingleDataset(str(tmp_path), "", ttf.TransformSpec(preprocess="none"))
    assert [b["A"].shape for b in DataLoader(ds, 2, shuffle=False)] == [(2, 3, 36, 40)] * 2
    assert len(list(DataLoader(ds, 2, shuffle=False, drop_last=False))) == 3
    native = list(DataLoader(ds, 2, shuffle=False, drop_last=False, worker_mode="native"))
    threads = list(DataLoader(ds, 2, shuffle=False, drop_last=False))
    assert len(native) == 3
    assert all(torch.equal(a["A"], b["A"]) and a["A_paths"] == b["A_paths"]
               for a, b in zip(native, threads))
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(ds, 2, worker_mode="dali")


def test_cityscapes_mode_names_its_roadmap_item(tmp_path):
    """The cityscapes mode now builds the Cityscapes loader (the SPADE
    family's data, the JAX package's ``CityscapesDataset`` items); the
    inception verbs' loader, whose tasks cannot read it, fails on it as the
    JAX package's generic loader does (the SPADE family reads it through its
    own loaders)."""
    from argparse import Namespace

    from cat_tpu.data.cityscapes import CityscapesDataset as JCityscapes
    from cat_tpu_torch.entry import _make_train_loader
    from tests.test_torch_spade import write_cityscapes

    root = write_cityscapes(str(tmp_path), n_train=2, n_val=0, size=(64, 32))
    spec = ttf.TransformSpec(load_size=32, crop_size=32, aspect_ratio=2.0)
    batch = next(iter(tds.create_dataloader("cityscapes", root, 2, spec, serial_batches=True)))
    want = JCityscapes(root, "train", load_size=32, crop_size=32, aspect_ratio=2.0)
    for j in range(2):
        np.testing.assert_array_equal(batch["label"][j].numpy(), want[j]["label"])
        np.testing.assert_array_equal(batch["image"][j].numpy(),
                                      want[j]["image"].transpose(2, 0, 1))
    # the inception verbs' loader fails on it as the JAX package's generic loader does
    with pytest.raises(NotImplementedError, match=r"dataset mode \[cityscapes\] not implemented"):
        _make_train_loader(Namespace(dataset_mode="cityscapes"), spec, torch.device("cpu"))


def test_device_prefetch_order_on_the_host():
    batches = [{"x": torch.full((1,), float(i)), "A_paths": [str(i)]} for i in range(5)]
    out = list(device_prefetch(iter(batches), torch.device("cpu")))
    assert [int(b["x"][0]) for b in out] == [0, 1, 2, 3, 4]
    assert [b["A_paths"] for b in out] == [[str(i)] for i in range(5)]


# ---------------------------------------------------------------------------
# The device-resident bank (mirrors tests/test_device_data.py)
# ---------------------------------------------------------------------------


def _bank(n=5, s=12, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, s, s, 3), dtype=np.uint8)


def test_sample_shapes_range_dtype():
    dd = DeviceData(_bank(), _bank(seed=1), crop_size=8, device="cpu")
    b = dd.sample(torch.Generator().manual_seed(0), 6)
    assert b["A"].shape == (6, 3, 8, 8) and b["B"].shape == (6, 3, 8, 8)
    assert b["A"].dtype == torch.float32 and b["A"].is_contiguous()
    assert float(b["A"].min()) >= -1.0 and float(b["A"].max()) <= 1.0


def test_sampling_function_of_given_draws_equals_the_jax_package():
    """The JAX package's draws (its key split, as ``_sample_side`` makes
    them) fed to the port's ``sample_side`` give its patches exactly,
    flips included."""
    bank = _bank(n=4, s=10)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ki, ky, kx, kf = jax.random.split(key, 4)
        n, crop = 16, 6
        draws = (jax.random.randint(ki, (n,), 0, 4), jax.random.randint(ky, (n,), 0, 5),
                 jax.random.randint(kx, (n,), 0, 5), jax.random.bernoulli(kf, 0.5, (n,)))
        ref = np.asarray(jax_sample_side(jnp.asarray(bank), key, n, crop, False))
        got = sample_side(torch.from_numpy(bank),
                          *(torch.from_numpy(np.array(d)) for d in draws), crop)
        np.testing.assert_array_equal(got.numpy(), ref.transpose(0, 3, 1, 2))
        assert bool(np.asarray(draws[3]).any())


def test_patches_are_true_crops_and_flips_mirror():
    bank = _bank(n=1, s=6)
    img = bank[0]
    crops = {img[y:y + 4, x:x + 4].tobytes() for y in range(3) for x in range(3)}
    mirrors = {img[y:y + 4, x:x + 4][:, ::-1].tobytes() for y in range(3) for x in range(3)}
    for no_flip in (True, False):
        dd = DeviceData(bank, None, crop_size=4, no_flip=no_flip, device="cpu")
        b = dd.sample(torch.Generator().manual_seed(3), 64)["A"]
        got = ((b + 1.0) * 127.5).round().to(torch.uint8).permute(0, 2, 3, 1).numpy()
        flipped = sum(p.tobytes() in mirrors - crops for p in got)
        assert all(p.tobytes() in crops | mirrors for p in got)
        assert all(p.tobytes() in crops for p in got) if no_flip else flipped > 0


def test_draws_follow_the_generator():
    dd = DeviceData(_bank(), _bank(seed=1), crop_size=8, device="cpu")
    a = dd.sample(torch.Generator().manual_seed(7), 4)
    b = dd.sample(torch.Generator().manual_seed(7), 4)
    assert torch.equal(a["A"], b["A"]) and torch.equal(a["B"], b["B"])
    idx, ys, xs, flip = draw(torch.Generator().manual_seed(0), 100, (5, 12, 12, 3), 8, False)
    assert int(idx.max()) <= 4 and int(ys.max()) <= 4 and int(xs.max()) <= 4
    assert 0 < int(flip.sum()) < 100


def test_from_unaligned_bank_and_epoch_pacing(tmp_path):
    write_images(tmp_path / "trainA", 4, size=(40, 40), seed=1)
    write_images(tmp_path / "trainB", 3, size=(40, 40), seed=2)
    dd, n = DeviceData.from_unaligned(str(tmp_path), "train", load_size=36, crop_size=32,
                                      device="cpu")
    assert n == 4
    # the JAX package's bank: its C++ pipeline where that builds, as here
    paths = tds.make_dataset(str(tmp_path / "trainA"))
    bank = stack_resized_uint8(paths, 36)
    np.testing.assert_array_equal(bank, jax_stack_resized_uint8(paths, 36))
    np.testing.assert_array_equal(dd.imgs_a.numpy(), bank)
    loader = DeviceDataLoader(dd, 2, max(n // 2, 1), seed=5)
    epochs = [list(loader), list(loader)]
    assert len(loader) == 2 and [len(e) for e in epochs] == [2, 2]
    assert epochs[0][0]["A"].shape == (2, 3, 32, 32)
    assert not torch.equal(epochs[0][0]["A"], epochs[1][0]["A"])  # a fresh seed per epoch
