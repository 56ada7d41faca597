"""Padding layers over NCHW; counterpart of ``refiners_tpu/fluxion/layers/padding.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion.layers.module import Module


class ReflectionPad2d(Module):
    def __init__(self, padding: int) -> None:
        super().__init__()
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        return F.pad(x, (p, p, p, p), mode="reflect")
