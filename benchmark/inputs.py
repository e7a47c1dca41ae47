"""The one generator of the benchmark's inputs: a bank of batches on the
card, made from the seed in one call a field.

A configuration names its inputs (``"inputs"`` in its file: a field name,
a kind and a per-image shape); a traffic mix sets the batch and how many
distinct batches the bank holds (``"batch"``, ``"bank"``).  The window
cycles through the bank, so no host loader paces a cell, and every batch's
rows differ.  Kinds:

* ``image``: values uniform in [-1, 1), as a normalised photo's;
* ``regions``: a label map (H, W) of ``classes`` labels in random axis-aligned
  regions (``regions`` rectangles painted in turn over a random background
  label), as a segmentation map has large areas of one class;
* ``instances``: an instance-id map made the same way, each region its own id.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _regions(n: int, h: int, w: int, classes: int, count: int, gen: torch.Generator,
             device) -> torch.Tensor:
    """(n, h, w) int64 maps: a background label, then ``count`` rectangles
    each painted with a label, in one pass of batched comparisons."""
    labels = torch.randint(0, classes, (n, count + 1), generator=gen, device=device)
    corners = torch.rand((n, count, 4), generator=gen, device=device)
    y0 = (corners[..., 0] * h).long()
    x0 = (corners[..., 1] * w).long()
    y1 = y0 + 1 + (corners[..., 2] * (h // 2)).long()
    x1 = x0 + 1 + (corners[..., 3] * (w // 2)).long()
    ys = torch.arange(h, device=device)[None, None, :, None]
    xs = torch.arange(w, device=device)[None, None, None, :]
    inside = ((ys >= y0[..., None, None]) & (ys < y1[..., None, None])
              & (xs >= x0[..., None, None]) & (xs < x1[..., None, None]))  # (n, count, h, w)
    # the last rectangle that covers a pixel wins; 0 means the background
    idx = torch.arange(1, count + 1, device=device)[None, :, None, None]
    top = (inside * idx).amax(dim=1)
    return labels.gather(1, top.reshape(n, -1)).reshape(n, h, w)


def make_bank(inputs: Dict[str, Dict], batch: int, n_batches: int, gen: torch.Generator,
              device) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` batches of ``batch`` rows of every input field, on
    ``device``, drawn from ``gen`` in a fixed order."""
    fields = {}
    n = batch * n_batches
    for name, spec in inputs.items():
        shape = tuple(spec["shape"])
        kind = spec["kind"]
        if kind == "image":
            fields[name] = torch.rand((n, *shape), generator=gen, device=device) * 2.0 - 1.0
        elif kind == "regions":
            fields[name] = _regions(n, *shape, spec["classes"], spec["regions"], gen, device)
        elif kind == "instances":
            fields[name] = _regions(n, *shape, 1 << 20, spec["regions"], gen, device)
        else:
            raise ValueError(f"input {name!r}: unknown kind {kind!r}")
    return [{k: v[i * batch:(i + 1) * batch] for k, v in fields.items()}
            for i in range(n_batches)]
