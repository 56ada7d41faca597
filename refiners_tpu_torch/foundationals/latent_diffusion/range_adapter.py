"""Timestep (range) conditioning; counterpart of
``refiners_tpu/foundationals/latent_diffusion/range_adapter.py``. The
sinusoidal embedding is always computed in float32 and cast down after."""

from __future__ import annotations

import math
from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter


def compute_sinusoidal_embedding(x: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """(...,) timesteps → (..., embedding_dim) float32 embedding [cos | sin]."""
    half_dim = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(half_dim, dtype=torch.float32, device=x.device) / half_dim
    embedding = x[..., None].float() * torch.exp(exponent)[None]
    return torch.cat([torch.cos(embedding), torch.sin(embedding)], dim=-1)


class RangeEncoder(fl.Chain):
    """Sinusoidal embedding → MLP."""

    def __init__(
        self,
        sinusoidal_embedding_dim: int,
        embedding_dim: int,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.sinusoidal_embedding_dim = sinusoidal_embedding_dim
        self.embedding_dim = embedding_dim
        super().__init__(
            fl.Lambda(self.compute_sinusoidal_embedding),
            fl.Converter(set_device=False, set_dtype=True),
            fl.Linear(in_features=sinusoidal_embedding_dim, out_features=embedding_dim, device=device, dtype=dtype),
            fl.SiLU(),
            fl.Linear(in_features=embedding_dim, out_features=embedding_dim, device=device, dtype=dtype),
        )

    def compute_sinusoidal_embedding(self, x: torch.Tensor) -> torch.Tensor:
        return compute_sinusoidal_embedding(x, embedding_dim=self.sinusoidal_embedding_dim)


class RangeAdapter2d(fl.Sum, Adapter[fl.Conv2d]):
    """Sum(conv, time embedding → SiLU → Linear → (C, 1, 1)) on the first conv
    of every ResidualBlock; the embedding broadcasts over NCHW."""

    def __init__(
        self,
        target: fl.Conv2d,
        channels: int,
        embedding_dim: int,
        context_key: str,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.channels = channels
        self.embedding_dim = embedding_dim
        with self.setup_adapter(target):
            super().__init__(
                target,
                fl.Chain(
                    fl.UseContext("range_adapter", context_key),
                    fl.SiLU(),
                    fl.Linear(in_features=embedding_dim, out_features=channels, device=device, dtype=dtype),
                    fl.Reshape(channels, 1, 1),
                ),
            )

    @property
    def context_key(self) -> str:
        """The key of the "range_adapter" context this adapter reads its embedding from."""
        use_context_module = self.ensure_find(fl.UseContext)
        assert use_context_module.context == "range_adapter"
        return use_context_module.key

    @context_key.setter
    def context_key(self, value: str) -> None:
        use_context_module = self.ensure_find(fl.UseContext)
        assert use_context_module.context == "range_adapter"
        use_context_module.key = value
