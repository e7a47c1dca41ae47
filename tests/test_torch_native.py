"""The port's C++ image pipeline against the JAX package's, on the CPU: the
source is the same file, so decode, resize, batch fetch and bank fill give
the same bytes; the ``native`` loader backend and the device bank give the
JAX package's pixels; without a toolchain both fall back to PIL.  Skipped
where g++, libjpeg or libpng is missing (both packages then use PIL)."""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cat_tpu import native as jnative
from cat_tpu.data import datasets as jds
from cat_tpu.data import transforms as jtf
from cat_tpu.data.device_data import stack_resized_uint8 as jax_stack
from cat_tpu.data.loader import DataLoader as JLoader
from cat_tpu_torch.data import datasets as tds
from cat_tpu_torch.data import native
from cat_tpu_torch.data import transforms as ttf
from cat_tpu_torch.data.device_data import stack_resized_uint8
from cat_tpu_torch.data.loader import DataLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pipes():
    port, ref = native.load_pipe(), jnative.load_pipe()
    if port is None or ref is None:
        pytest.skip(f"the native pipeline does not build here: {native.pipe_error()}")
    return port, ref


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("imgs")
    rs = np.random.RandomState(0)
    arr = rs.randint(0, 256, (47, 61, 3), dtype=np.uint8)
    out = {}
    for name, img, kw in (("png", Image.fromarray(arr), {}),
                          ("jpg", Image.fromarray(arr), {"quality": 92}),
                          ("gray", Image.fromarray(arr[:, :, 0]), {}),
                          ("pal", Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE), {})):
        out[name] = str(tmp / f"{name}.{'jpg' if name == 'jpg' else 'png'}")
        img.save(out[name], **kw)
    return out


def test_image_pipe_source_is_a_byte_identical_copy():
    assert filecmp.cmp(os.path.join(REPO, "cat_tpu_torch", "csrc", "image_pipe.cpp"),
                       os.path.join(REPO, "cat_tpu", "native", "image_pipe.cpp"), shallow=False)


def test_the_library_is_built_into_the_ports_build_dir(pipes):
    built = [f for f in os.listdir(native.BUILD_DIR) if f.startswith("_image_pipe_")]
    assert any(f.endswith(".so") for f in built)


@pytest.mark.parametrize("key", ["png", "jpg", "gray", "pal"])
@pytest.mark.parametrize("method", [Image.BILINEAR, Image.BICUBIC])
def test_decode_resize_is_bit_identical(pipes, images, key, method):
    port, ref = pipes
    filt = native.native_filter_for(method)
    assert filt == jnative.native_filter_for(method)
    for size in (40, 64):
        np.testing.assert_array_equal(port.decode_resize(images[key], size, filt),
                                      ref.decode_resize(images[key], size, filt))


def test_fetch_batch_and_fill_bank_are_bit_identical(pipes, images):
    port, ref = pipes
    paths = [images["png"], images["jpg"], images["pal"]]
    args = (paths, 36, 20, np.array([3, 7, 0], np.int32), np.array([5, 1, 16], np.int32),
            np.array([0, 1, 1], np.uint8))
    np.testing.assert_array_equal(port.fetch_batch(*args, nthreads=2),
                                  ref.fetch_batch(*args, nthreads=2))
    np.testing.assert_array_equal(port.fill_bank(paths, 24, nthreads=3),
                                  ref.fill_bank(paths, 24, nthreads=3))


def test_missing_file_and_bad_arguments_raise(pipes):
    port, _ = pipes
    with pytest.raises(IOError):
        port.decode_resize("/nonexistent/x.png", 16)
    with pytest.raises(IOError):
        port.fill_bank(["/nonexistent/x.png"], 16)
    with pytest.raises(ValueError, match="one crop and flip per path"):
        port.fetch_batch(["a.png", "b.png"], 16, 8, np.zeros(1, np.int32),
                         np.zeros(2, np.int32), np.zeros(2, np.uint8))


def _unaligned(root, exts=("png", "png")):
    rs = np.random.RandomState(3)
    for side, n, ext in (("trainA", 5, exts[0]), ("trainB", 4, exts[1])):
        d = root / side
        d.mkdir()
        for i in range(n):
            Image.fromarray(rs.randint(0, 256, (50, 44, 3), dtype=np.uint8)).save(
                d / f"{i}.{ext}")
    return str(root)


def test_native_batch_equals_the_jax_package(pipes, tmp_path):
    """The same draws (paths, crops, flips) and the same pixels, NCHW here."""
    port, ref = pipes
    root = _unaligned(tmp_path, ("png", "jpg"))
    spec = dict(preprocess="resize_and_crop", load_size=36, crop_size=32)
    t = tds.UnalignedDataset(root, "train", ttf.TransformSpec(**spec), seed=11)
    j = jds.UnalignedDataset(root, "train", jtf.TransformSpec(**spec), seed=11)
    assert t.native_supported() and j.native_supported()
    for idx in ([0, 3, 1], [4, 2]):
        got, want = t.native_batch(idx, port, 2), j.native_batch(idx, ref, 2)
        assert got["A_paths"] == want["A_paths"] and got["B_paths"] == want["B_paths"]
        for side in "AB":
            assert got[side].flags.c_contiguous
            np.testing.assert_array_equal(got[side], want[side].transpose(0, 3, 1, 2))


@pytest.mark.parametrize("workers", [1, 3])
def test_native_loader_gives_the_jax_package_batches(pipes, tmp_path, workers):
    """``worker_mode="native"`` over two shuffled epochs: the JAX package's
    native batches, bit for bit, as NCHW tensors."""
    root = _unaligned(tmp_path)
    spec = dict(preprocess="resize_and_crop", load_size=36, crop_size=32)

    def stream(mod, loader_cls, tspec):
        ds = mod.UnalignedDataset(root, "train", tspec(**spec), seed=5)
        loader = loader_cls(ds, 2, shuffle=True, seed=9, drop_last=True, num_workers=workers,
                            worker_mode="native")
        out = [b for _ in range(2) for b in loader]
        loader.close()
        return out

    got, want = stream(tds, DataLoader, ttf.TransformSpec), stream(jds, JLoader,
                                                                   jtf.TransformSpec)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert isinstance(g[k], torch.Tensor) and g[k].is_contiguous()
                np.testing.assert_array_equal(g[k].numpy(), w[k].transpose(0, 3, 1, 2))
            else:
                assert g[k] == list(w[k])


def test_unsupported_files_fall_back_to_the_thread_backend(pipes, tmp_path):
    """A container the pipeline cannot read (webp) makes the whole loader
    decode with PIL from the start: the thread backend's batches."""
    root = _unaligned(tmp_path, ("png", "webp"))
    spec = ttf.TransformSpec(preprocess="resize_and_crop", load_size=36, crop_size=32)
    streams = []
    for mode in ("native", "thread"):
        ds = tds.UnalignedDataset(root, "train", spec, seed=5)
        assert not ds.native_supported()
        streams.append(list(DataLoader(ds, 2, seed=9, num_workers=2, worker_mode=mode)))
    for a, b in zip(*streams):
        assert torch.equal(a["A"], b["A"]) and torch.equal(a["B"], b["B"])


def test_device_bank_equals_the_jax_packages(pipes, tmp_path):
    paths = tds.make_dataset(_unaligned(tmp_path) + "/trainA")
    np.testing.assert_array_equal(stack_resized_uint8(paths, 40), jax_stack(paths, 40))


def test_a_failed_build_prints_its_error_and_falls_back_to_pil(tmp_path, monkeypatch, capsys):
    """A source g++ refuses: ``load_pipe`` returns None once, with the
    compiler's error printed, and the bank is PIL's."""
    bad = tmp_path / "image_pipe.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_pipe", None)
    monkeypatch.setattr(native, "_pipe_err", None)
    assert native.load_pipe() is None
    assert "image_pipe.cpp" in native.pipe_error()
    assert "native image pipeline is unavailable" in capsys.readouterr().out
    assert native.load_pipe() is None and capsys.readouterr().out == ""  # printed once
    paths = tds.make_dataset(_unaligned(tmp_path) + "/trainA")
    want = np.stack([np.asarray(Image.open(p).convert("RGB").resize((36, 36), Image.BICUBIC))
                     for p in paths])
    np.testing.assert_array_equal(stack_resized_uint8(paths, 36), want)
