"""Linear layers; counterpart of ``refiners_tpu/fluxion/layers/linear.py``.

The weight is torch's (out_features, in_features); the JAX package stores
(in, out), which the weight bridge transposes.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.layers.activations import ReLU
from refiners_tpu_torch.fluxion.layers.chain import Chain
from refiners_tpu_torch.fluxion.layers.module import Module, WeightedModule


class Linear(WeightedModule):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)
        self.weight = rng.init_uniform((out_features, in_features), bound, device=device, dtype=dtype)
        self.bias = rng.init_uniform((out_features,), bound, device=device, dtype=dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiLinear(Chain):
    """MLP stack: Linear (+ ReLU between layers) × num_layers."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        inner_dim: int,
        num_layers: int,
        bias: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        layers: list[Module] = []
        for i in range(num_layers):
            is_last = i == num_layers - 1
            layers.append(
                Linear(
                    input_dim if i == 0 else inner_dim,
                    output_dim if is_last else inner_dim,
                    bias=bias,
                    device=device,
                    dtype=dtype,
                )
            )
            if not is_last:
                layers.append(ReLU())
        super().__init__(*layers)
