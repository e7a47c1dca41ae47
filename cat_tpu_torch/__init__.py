"""PyTorch/CUDA port of the CAT compression framework.

A second package beside ``cat_tpu`` (the JAX reference), with the same
module layout.  Activations are NCHW; state_dicts use the reference CAT key
layout.  Entry points run on CUDA unless the caller asks for the CPU with
``device="cpu"``; the two TPU kernels of ``cat_tpu`` are hand-written CUDA
kernels here (``cat_tpu_torch/csrc``), with a plain PyTorch twin that runs
only for tensors on the CPU.
"""

from __future__ import annotations

import os
import sys

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.  Raises (never falls back to the CPU) when CUDA is asked for
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def import_stdlib_profile() -> None:
    """Import the standard library's ``profile`` module, which TorchDynamo
    reaches through ``cProfile`` (``torch.utils.checkpoint``,
    ``torch.profiler``).  A ``profile.py`` in a directory on ``sys.path``
    (this repository's root holds the JAX package's profile verb) would be
    imported in its place."""
    if "profile" in sys.modules:
        return
    stdlib = os.path.dirname(os.__file__)
    saved = sys.path[:]
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") == stdlib
                   or not os.path.isfile(os.path.join(p or ".", "profile.py"))]
    try:
        import cProfile  # noqa: F401
        import profile  # noqa: F401
    finally:
        sys.path[:] = saved
