"""Pixel (un)shuffle over NCHW; counterpart of
``refiners_tpu/fluxion/layers/pixelshuffle.py``. The JAX layers reproduce
torch's channel order on NHWC (out channel = c·r² + dy·r + dx), which is
``F.pixel_unshuffle``'s own."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion.layers.module import Module


class PixelUnshuffle(Module):
    """(B, C, H·r, W·r) → (B, C·r², H, W)."""

    def __init__(self, downscale_factor: int) -> None:
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_unshuffle(x, self.downscale_factor)


class PixelShuffle(Module):
    """(B, C·r², H, W) → (B, C, H·r, W·r), the inverse of PixelUnshuffle."""

    def __init__(self, upscale_factor: int) -> None:
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.pixel_shuffle(x, self.upscale_factor)
