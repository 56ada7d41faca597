"""Activation layers; counterpart of ``refiners_tpu/fluxion/layers/activations.py``."""

from __future__ import annotations

from enum import Enum

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion.layers.module import Module


class Activation(Module):
    """Base class for activation layers."""


class ReLU(Activation):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class SiLU(Activation):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x)


class GeLUApproximation(Enum):
    NONE = "none"
    TANH = "tanh"
    SIGMOID = "sigmoid"


class GeLU(Activation):
    """GeLU with selectable approximation."""

    def __init__(self, approximation: GeLUApproximation = GeLUApproximation.NONE) -> None:
        super().__init__()
        self.approximation = approximation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        match self.approximation:
            case GeLUApproximation.NONE:
                return F.gelu(x)
            case GeLUApproximation.TANH:
                return F.gelu(x, approximate="tanh")
            case GeLUApproximation.SIGMOID:
                # "quick gelu": x * sigmoid(1.702 x) — used by CLIP-L
                return x * torch.sigmoid(1.702 * x)


class GLU(Activation):
    """Gated linear unit: split the last dim in two, gate with `activation`."""

    def __init__(self, activation: Activation) -> None:
        super().__init__()
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[-1] % 2 == 0, "Non-batch input dimension must be divisible by 2"
        value, gate = x.chunk(2, dim=-1)
        return value * self.activation(gate)
