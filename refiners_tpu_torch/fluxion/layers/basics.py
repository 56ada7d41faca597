"""Basic shape/value manipulation layers.

Counterpart of ``refiners_tpu/fluxion/layers/basics.py``; all stateless
except `Parameter` and `Buffer`.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.layers.module import Module, WeightedModule


class Identity(Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class GetArg(Module):
    """Return the n-th positional argument."""

    def __init__(self, index: int) -> None:
        super().__init__()
        self.index = index

    def forward(self, *args: Any) -> Any:
        return args[self.index]


class Flatten(Module):
    """Flatten dims [start_dim, end_dim]."""

    def __init__(self, start_dim: int = 0, end_dim: int = -1) -> None:
        super().__init__()
        self.start_dim = start_dim
        self.end_dim = end_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.flatten(self.start_dim, self.end_dim)


class Unflatten(Module):
    """Unflatten `dim` into `sizes`, given at call time."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
        return x.unflatten(self.dim, tuple(sizes))


class Reshape(Module):
    """Reshape non-batch dims to `shape` (the batch dim is kept)."""

    def __init__(self, *shape: int) -> None:
        super().__init__()
        self.shape = shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], *self.shape)


class Transpose(Module):
    """Swap two dims."""

    def __init__(self, dim0: int, dim1: int) -> None:
        super().__init__()
        self.dim0 = dim0
        self.dim1 = dim1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(self.dim0, self.dim1)


class Permute(Module):
    """Permute dims."""

    def __init__(self, *dims: int) -> None:
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)


class Slicing(Module):
    """Slice along `dim` with start/end/step."""

    def __init__(self, dim: int = 0, start: int = 0, end: int | None = None, step: int = 1) -> None:
        super().__init__()
        self.dim = dim
        self.start = start
        self.end = end
        self.step = step

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = [slice(None)] * x.ndim
        idx[self.dim] = slice(self.start, self.end, self.step)
        return x[tuple(idx)]


class Unsqueeze(Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(self.dim)


class Squeeze(Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.squeeze(self.dim)


class Sin(Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(x)


class Cos(Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cos(x)


class Multiply(Module):
    """scale * x + bias."""

    def __init__(self, scale: float = 1.0, bias: float = 0.0) -> None:
        super().__init__()
        self.scale = scale
        self.bias = bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.bias


class Parameter(WeightedModule):
    """A learnable tensor returned whatever the input, broadcast over its batch."""

    def __init__(self, *dims: int, requires_grad: bool = True, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.dims = dims
        self.weight = rng.init_normal(dims, device=device, dtype=dtype)
        self.weight.requires_grad_(requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight.expand(x.shape[0], *self.dims)


class Buffer(WeightedModule):
    """A non-learnable tensor returned whatever the input: a persistent
    buffer, so it keeps its place in ``state_dict()``."""

    weight: torch.Tensor  # type: ignore[assignment]

    def __init__(self, *dims: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.dims = dims
        self.register_buffer("weight", torch.zeros(dims, device=device, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight
