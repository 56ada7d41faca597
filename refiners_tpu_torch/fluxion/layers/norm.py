"""Normalization layers; counterpart of ``refiners_tpu/fluxion/layers/norm.py``.

Statistics are taken in float32 and the output is cast back to the input
dtype, as in the JAX package. Spatial tensors are NCHW here, so GroupNorm
groups channel dim 1 and LayerNorm2d normalizes over it.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.layers.module import WeightedModule


def _normalize(x32: torch.Tensor, dims: tuple[int, ...], eps: float) -> torch.Tensor:
    var, mean = torch.var_mean(x32, dim=dims, keepdim=True, correction=0)
    return (x32 - mean) * torch.rsqrt(var + eps)


class LayerNorm(WeightedModule):
    """LayerNorm over the trailing dims."""

    def __init__(
        self, normalized_shape: int | tuple[int, ...], eps: float = 1e-5, device: Any = None, dtype: Any = None
    ) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.weight = rng.ones(self.normalized_shape, device=device, dtype=dtype)
        self.bias = rng.zeros(self.normalized_shape, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(x.ndim - len(self.normalized_shape), x.ndim))
        y = _normalize(x.float(), dims, self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class GroupNorm(WeightedModule):
    """GroupNorm over channel dim 1 of (N, C, ...) tensors."""

    def __init__(
        self, channels: int, num_groups: int, eps: float = 1e-5, device: Any = None, dtype: Any = None
    ) -> None:
        super().__init__()
        assert channels % num_groups == 0, "Number of channels must be divisible by number of groups"
        self.channels = channels
        self.num_groups = num_groups
        self.eps = eps
        self.weight = rng.ones((channels,), device=device, dtype=dtype)
        self.bias = rng.zeros((channels,), device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        y = _normalize(x.reshape(b, self.num_groups, -1).float(), (2,), self.eps).reshape(x.shape)
        affine = (-1,) + (1,) * (x.ndim - 2)
        return (y * self.weight.float().reshape(affine) + self.bias.float().reshape(affine)).to(x.dtype)


class LayerNorm2d(WeightedModule):
    """LayerNorm over the channel dim 1 of (N, C, H, W), with a per-channel
    affine (the JAX package's normalizes its trailing channel axis)."""

    def __init__(self, channels: int, eps: float = 1e-6, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.channels = channels
        self.eps = eps
        self.weight = rng.ones((channels,), device=device, dtype=dtype)
        self.bias = rng.zeros((channels,), device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x.float(), (1,), self.eps)
        affine = (-1,) + (1,) * (x.ndim - 2)
        return (y * self.weight.float().reshape(affine) + self.bias.float().reshape(affine)).to(x.dtype)
