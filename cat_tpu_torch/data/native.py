"""ctypes binding of the C++ image pipeline (port of ``cat_tpu/native``).

``cat_tpu_torch/csrc/image_pipe.cpp`` is a byte-identical copy of the JAX
package's ``cat_tpu/native/image_pipe.cpp``: libjpeg/libpng decode, PIL's
antialiased bilinear and bicubic filters, crop, flip and normalise, over a
``std::thread`` pool that runs without the GIL.  It is compiled on first use
with g++ into ``cat_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries the source's hash, so an edited source is rebuilt.  Where
g++, libjpeg or libpng is missing, ``load_pipe`` prints the build error once
and returns None, and the callers decode with PIL, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "image_pipe.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

# PIL resample constant -> native filter id (image_pipe.cpp ABI)
_PIL_FILTER = {2: 0, 3: 1}  # Image.BILINEAR -> 0, Image.BICUBIC -> 1


def native_filter_for(method) -> Optional[int]:
    """Native filter id for a PIL resample constant; None if unsupported."""
    return _PIL_FILTER.get(int(method))


_lock = threading.Lock()
_pipe = None
_pipe_err: Optional[str] = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"_image_pipe_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # libraries of older sources, and temp files of crashed builds; a recent
    # temp file is another process's build in progress, so it stays
    now = time.time()
    for name in os.listdir(BUILD_DIR):
        path = os.path.join(BUILD_DIR, name)
        try:
            if name.startswith("_image_pipe_") and name.endswith(".so"):
                os.unlink(path)
            elif (name.startswith("_image_pipe_") and name.endswith(".tmp")
                  and now - os.path.getmtime(path) > 300):
                os.unlink(path)
        except OSError:
            pass
    tmp = f"{so_path}.{os.getpid()}.tmp"  # per process: concurrent first builds
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           "-ljpeg", "-lpng", "-pthread"]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed on csrc/image_pipe.cpp: {out.stderr.strip()}")
    try:
        os.replace(tmp, so_path)
    except OSError:
        # a racing build published the same source's library first
        if not os.path.exists(so_path):
            raise
    return so_path


class ImagePipe:
    """Typed wrapper over the C ABI.  Images come out HWC, as the JAX
    package's do; the callers lay them out for the port's NCHW batches."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.cat_decode_resize.restype = ctypes.c_int
        lib.cat_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
        lib.cat_fetch_batch.restype = ctypes.c_int
        lib.cat_fetch_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.cat_fill_bank.restype = ctypes.c_int
        lib.cat_fill_bank.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]

    @staticmethod
    def _paths_array(paths: Sequence[str]):
        arr = (ctypes.c_char_p * len(paths))()
        arr[:] = [p.encode() for p in paths]
        return arr

    def decode_resize(self, path: str, load_size: int, filter: int = 1) -> np.ndarray:
        """One image decoded and resized to (load, load, 3) uint8."""
        out = np.empty((load_size, load_size, 3), np.uint8)
        rc = self._lib.cat_decode_resize(path.encode(), load_size, filter,
                                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc:
            raise IOError(f"native decode failed: {path}")
        return out

    def fetch_batch(self, paths: Sequence[str], load_size: int, crop_size: int,
                    crop_x: np.ndarray, crop_y: np.ndarray, flip: np.ndarray,
                    nthreads: int = 4, filter: int = 1) -> np.ndarray:
        """A batch of float32 [-1, 1] NHWC crops, decoded on C++ threads."""
        n = len(paths)
        if not len(crop_x) == len(crop_y) == len(flip) == n:
            raise ValueError("fetch_batch takes one crop and flip per path")
        out = np.empty((n, crop_size, crop_size, 3), np.float32)
        cx = np.ascontiguousarray(crop_x, np.int32)
        cy = np.ascontiguousarray(crop_y, np.int32)
        fl = np.ascontiguousarray(flip, np.uint8)
        rc = self._lib.cat_fetch_batch(
            self._paths_array(paths), n, load_size, crop_size, filter,
            cx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cy.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            fl.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
        if rc:
            raise IOError(f"native decode failed: {paths[rc - 1]}")
        return out

    def fill_bank(self, paths: Sequence[str], load_size: int, nthreads: int = 4,
                  filter: int = 1) -> np.ndarray:
        """(N, load, load, 3) uint8 stack for the device-resident bank."""
        n = len(paths)
        out = np.empty((n, load_size, load_size, 3), np.uint8)
        rc = self._lib.cat_fill_bank(self._paths_array(paths), n, load_size, filter,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                     nthreads)
        if rc:
            raise IOError(f"native decode failed: {paths[rc - 1]}")
        return out


def load_pipe() -> Optional[ImagePipe]:
    """Build (once per process) and load the pipeline; None, with the build
    error printed once, where it cannot be built."""
    global _pipe, _pipe_err
    with _lock:
        if _pipe is not None or _pipe_err is not None:
            return _pipe
        try:
            _pipe = ImagePipe(ctypes.CDLL(_build()))
        except (OSError, RuntimeError) as e:  # no g++, libjpeg or libpng
            _pipe_err = str(e)
            print(f"WARNING: the native image pipeline is unavailable, decoding with PIL: "
                  f"{_pipe_err}", flush=True)
        return _pipe


def pipe_error() -> Optional[str]:
    """The build error of ``load_pipe``, or None."""
    return _pipe_err
