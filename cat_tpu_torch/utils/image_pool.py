"""Image replay buffer for the CycleGAN discriminators (port of
``cat_tpu/utils/image_pool.py``).

Reference semantics (utils/image_pool.py:22-53), image by image in batch
order: while the pool is not full the image is stored and returned as it
is; once it is full, with p = 0.5 a random pool entry is returned and the
image takes its place, else the image passes through.

As in the JAX package the buffer is a preallocated (pool_size, C, H, W)
tensor on the device.  The fill count and the coin and index draws stay on
the host (a seeded CPU ``torch.Generator``), so a query is a few device
copies and never waits for the device.  Over several ranks every rank
holds the same pool and queries it with the global batch
(``train/cyclegan.py``), so the draws, seeded alike, stay the same.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


class ImagePool:
    def __init__(self, pool_size: int, channels: int, height: int, width: int,
                 device=None, seed: int = 0):
        self.pool_size = pool_size
        self.buffer = torch.zeros((pool_size, channels, height, width), device=device)
        self.count = 0
        self.generator = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def query(self, images: torch.Tensor) -> torch.Tensor:
        """Mix the incoming (N, C, H, W) batch with the buffered history."""
        if self.pool_size == 0:
            return images
        out: Optional[torch.Tensor] = None
        for i in range(images.shape[0]):
            if self.count < self.pool_size:
                self.buffer[self.count].copy_(images[i])
                self.count += 1
            elif float(torch.rand((), generator=self.generator)) > 0.5:
                idx = int(torch.randint(self.pool_size, (), generator=self.generator))
                if out is None:
                    out = images.clone()
                out[i].copy_(self.buffer[idx])
                self.buffer[idx].copy_(images[i])
        return images if out is None else out

    def state_dict(self) -> Dict[str, Any]:
        return {"buffer": self.buffer, "count": self.count,
                "rng": self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore ``state_dict``'s output (the draws' generator only where
        ``sd`` has one)."""
        if tuple(sd["buffer"].shape) != tuple(self.buffer.shape):
            raise ValueError(f"image pool: buffer {tuple(sd['buffer'].shape)} in the checkpoint, "
                             f"{tuple(self.buffer.shape)} here")
        self.buffer.copy_(sd["buffer"])
        self.count = int(sd["count"])
        if "rng" in sd:
            self.generator.set_state(sd["rng"])
