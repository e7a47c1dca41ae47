"""Student export for deployment (port of ``cat_tpu/export.py``).

The reference exports the student to ONNX with a dynamic batch
(onnx_exporter.py:134-163); the JAX package writes StableHLO with a
symbolic batch.  The port writes a ``torch.export`` program (``.pt2``) with
a symbolic batch: ``torch.export.load(path).module()`` runs it wherever
torch runs, on the device its weights were exported on.  Inputs and
outputs are NCHW, where the JAX package's artifact is NHWC.

The program holds the plain layers only (no custom CUDA op, as the JAX
package exports no Pallas call), so it loads where ``csrc/`` was never
built; spectral convs are folded into plain convs of their eval-mode
normalised kernel.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from cat_tpu_torch import import_stdlib_profile, resolve_device
from cat_tpu_torch.core.config import InceptionGeneratorConfig
from cat_tpu_torch.ops.spectral import fold_spectral


class _Forward(nn.Module):
    """A generator's eval-mode forward as a function of one tensor: its
    ``train`` and ``taps`` arguments stay out of the exported signature."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def _forward_fn(cfg, state_dict: Dict[str, torch.Tensor]
                ) -> Tuple[nn.Module, Tuple[int, Optional[int], Optional[int]]]:
    """(eval-mode module of one NCHW tensor, per-sample input shape) for a
    generator config, as ``cat_tpu/export.py::_forward_fn``: an inception
    student takes ``(input_nc, H, W)``, H and W (None here) from the caller;
    a SPADE student takes the one-hot semantic map (+ dontcare and edges) at
    ``(semantic_nc, int(crop_size / aspect_ratio), crop_size)``."""
    from cat_tpu_torch.core.spade_config import SPADEGeneratorConfig

    if isinstance(cfg, SPADEGeneratorConfig):
        from cat_tpu_torch.models.spade import SPADEGenerator

        net = SPADEGenerator(cfg)
        shape = (cfg.semantic_nc, int(cfg.crop_size / cfg.aspect_ratio), cfg.crop_size)
    elif isinstance(cfg, InceptionGeneratorConfig):
        from cat_tpu_torch.models.generator import InceptionGenerator

        net = InceptionGenerator(cfg, packed_blocks=True)
        shape = (cfg.input_nc, None, None)
    else:
        raise NotImplementedError(f"export for config type {type(cfg).__name__}")
    net.load_state_dict(state_dict)
    return _Forward(fold_spectral(net)).requires_grad_(False).eval(), shape


def export_program(cfg, state_dict: Dict[str, torch.Tensor], height: int, width: int,
                   path: str, dynamic_batch: bool = True, device=None) -> str:
    """Write the student's forward as a ``torch.export`` program at ``path``
    (``torch.export.save``) with a symbolic batch, or batch 1 without
    ``dynamic_batch``; traced on ``device`` (CUDA unless the caller says
    otherwise), whose weights the program holds.  Returns ``path``."""
    import_stdlib_profile()  # torch.export reaches TorchDynamo
    device = resolve_device(device)
    module, (c, h, w) = _forward_fn(cfg, state_dict)
    # an example batch of 2: torch.export specialises a size of 1
    x = torch.zeros((2 if dynamic_batch else 1, c, h or height, w or width), device=device)
    dynamic = {"x": {0: torch.export.Dim("batch")}} if dynamic_batch else None
    program = torch.export.export(module.to(device), (x,), dynamic_shapes=dynamic)
    program.example_inputs = None  # the zeros it was traced on are no part of the artifact
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_program(path: str) -> nn.Module:
    """The exported student, callable on an NCHW batch."""
    import_stdlib_profile()
    return torch.export.load(path).module()
