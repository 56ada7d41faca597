"""Max pooling layers; counterpart of ``refiners_tpu/fluxion/layers/maxpool.py``,
whose inputs are channels-last: here (B, C, L) and (B, C, H, W)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion.layers.module import Module


class MaxPool1d(Module):
    def __init__(self, kernel_size: int, stride: int | None = None, padding: int = 0) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class MaxPool2d(Module):
    def __init__(
        self, kernel_size: int | tuple[int, int], stride: int | tuple[int, int] | None = None, padding: int = 0
    ) -> None:
        super().__init__()
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
        st = ks if stride is None else ((stride, stride) if isinstance(stride, int) else tuple(stride))
        self.kernel_size = ks
        self.stride = st
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)
