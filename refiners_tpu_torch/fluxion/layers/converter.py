"""Converter layer: move inputs to the parent chain's device and cast floating
inputs to its dtype. Counterpart of ``refiners_tpu/fluxion/layers/converter.py``;
the device move is what brings host-side token ids onto the card."""

from __future__ import annotations

import torch

from refiners_tpu_torch.fluxion.layers.module import ContextModule


class Converter(ContextModule):
    def __init__(self, set_device: bool = True, set_dtype: bool = True) -> None:
        super().__init__()
        self.set_device = set_device
        self.set_dtype = set_dtype

    def forward(self, *inputs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        parent = self.ensure_parent
        device = parent.device if self.set_device else None
        dtype = parent.dtype if self.set_dtype else None
        # to the card without a wait: a page-locked host tensor's copy is then one a CUDA graph capture holds
        non_blocking = device is not None and device.type == "cuda"
        return tuple(
            x.to(device=device, dtype=dtype if x.is_floating_point() else None, non_blocking=non_blocking)
            for x in inputs
        )
