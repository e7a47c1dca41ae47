"""Build and load the hand-written CUDA kernels of ``cat_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled on first use by
``nvcc`` into its own shared library under ``cat_tpu_torch/_build/`` (listed
in ``.gitignore``), then loaded with ``ctypes``.  A library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded.  ``build_all`` starts one ``nvcc`` per source, all
at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    the running process (or None) and the library's path."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(f"{out}.log", "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT,
    )
    return (proc, tmp, log), out


def _finish(name: str, started) -> None:
    job, out = started
    if job is None:
        return
    proc, tmp, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(f"{out}.log") as f:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{f.read()}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that has no library yet, in parallel."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        for n, s in started.items():
            _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
