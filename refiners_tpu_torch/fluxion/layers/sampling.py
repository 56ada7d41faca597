"""Spatial up/downsampling layers over NCHW tensors.

Counterpart of ``refiners_tpu/fluxion/layers/sampling.py``. Shapes registered
in the "sampling" context are (H, W) tuples, popped by the matching Upsample.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion.layers.basics import Identity
from refiners_tpu_torch.fluxion.layers.chain import Chain, Lambda, Parallel, SetContext, UseContext
from refiners_tpu_torch.fluxion.layers.conv import Conv2d
from refiners_tpu_torch.fluxion.layers.module import Module


class Interpolate(Module):
    """Resize an NCHW tensor to a target spatial shape."""

    def __init__(self, mode: str = "nearest", antialias: bool = False) -> None:
        super().__init__()
        self.mode = mode
        self.antialias = antialias

    def forward(self, x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
        from refiners_tpu_torch.fluxion.utils import interpolate

        return interpolate(x, size=tuple(shape), mode=self.mode, antialias=self.antialias)


def _pad_bottom_right(x: torch.Tensor) -> torch.Tensor:
    """The SD VAE's asymmetric downsampling pad: right and bottom only."""
    return F.pad(x, (0, 1, 0, 1))


class Downsample(Chain):
    """Strided-conv downsample by `scale_factor`."""

    def __init__(
        self,
        channels: int,
        scale_factor: int,
        padding: int = 0,
        register_shape: bool = True,
        device: Any = None,
        dtype: Any = None,
    ):
        self.channels = channels
        self.in_channels = channels
        self.out_channels = channels
        self.scale_factor = scale_factor
        self.padding = padding
        super().__init__(
            Conv2d(
                in_channels=channels,
                out_channels=channels,
                kernel_size=3,
                stride=scale_factor,
                padding=padding,
                device=device,
                dtype=dtype,
            ),
        )
        if padding == 0:
            self.insert(index=0, module=Lambda(func=_pad_bottom_right))
        if register_shape:
            self.insert(index=0, module=SetContext(context="sampling", key="shapes", callback=self.register_shape))

    def register_shape(self, shapes: list[tuple[int, int]], x: torch.Tensor) -> None:
        shapes.append(tuple(x.shape[2:4]))


class Upsample(Chain):
    """Nearest-upsample (to the context's shape or by a factor), then 3×3 conv."""

    def __init__(
        self,
        channels: int,
        upsample_factor: int | None = None,
        device: Any = None,
        dtype: Any = None,
    ):
        self.channels = channels
        self.upsample_factor = upsample_factor
        super().__init__(
            Parallel(
                Identity(),
                (
                    Lambda(self._get_static_shape)
                    if upsample_factor is not None
                    else UseContext(context="sampling", key="shapes").compose(lambda x: x.pop())
                ),
            ),
            Interpolate(),
            Conv2d(in_channels=channels, out_channels=channels, kernel_size=3, padding=1, device=device, dtype=dtype),
        )

    def _get_static_shape(self, x: torch.Tensor) -> tuple[int, int]:
        assert self.upsample_factor is not None
        return tuple(size * self.upsample_factor for size in x.shape[2:4])  # type: ignore[return-value]
