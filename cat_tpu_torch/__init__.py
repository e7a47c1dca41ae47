"""PyTorch/CUDA port of the CAT compression framework.

A second package beside ``cat_tpu`` (the JAX reference), with the same
module layout.  Activations are NCHW; state_dicts use the reference CAT key
layout.  Entry points run on CUDA unless the caller asks for the CPU with
``device="cpu"``; the two TPU kernels of ``cat_tpu`` are hand-written CUDA
kernels here (``cat_tpu_torch/csrc``), with a plain PyTorch twin that runs
only for tensors on the CPU.
"""

from __future__ import annotations

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
