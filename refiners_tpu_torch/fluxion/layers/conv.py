"""Convolution layers over NCHW tensors with OIHW weights.

Counterpart of ``refiners_tpu/fluxion/layers/conv.py``, whose layout is
NHWC/HWIO; the weight bridge permutes HWIO to OIHW.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.layers.module import WeightedModule


def _pair(v: int | tuple[int, int]) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore[return-value]


class Conv2d(WeightedModule):
    """2D convolution on NCHW tensors."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | tuple[int, int],
        stride: int | tuple[int, int] = (1, 1),
        padding: int | tuple[int, int] | str = (0, 0),
        groups: int = 1,
        use_bias: bool = True,
        dilation: int | tuple[int, int] = (1, 1),
        padding_mode: str = "zeros",
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding if isinstance(padding, str) else _pair(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.use_bias = use_bias
        self.padding_mode = padding_mode
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(in_channels // groups * kh * kw)
        self.weight = rng.init_uniform((out_channels, in_channels // groups, kh, kw), bound, device=device, dtype=dtype)
        self.bias = rng.init_uniform((out_channels,), bound, device=device, dtype=dtype) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose2d(WeightedModule):
    """2D transposed convolution on NCHW tensors; weight (in, out, kh, kw)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | tuple[int, int],
        stride: int | tuple[int, int] = 1,
        padding: int | tuple[int, int] = 0,
        output_padding: int | tuple[int, int] = 0,
        groups: int = 1,
        use_bias: bool = True,
        dilation: int | tuple[int, int] = 1,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        assert groups == 1, "groups != 1 not supported for ConvTranspose2d"
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.dilation = _pair(dilation)
        self.use_bias = use_bias
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(out_channels * kh * kw)
        self.weight = rng.init_uniform((in_channels, out_channels, kh, kw), bound, device=device, dtype=dtype)
        self.bias = rng.init_uniform((out_channels,), bound, device=device, dtype=dtype) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.output_padding, 1, self.dilation
        )
