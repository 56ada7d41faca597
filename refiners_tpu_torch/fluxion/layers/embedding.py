"""Embedding layer; counterpart of ``refiners_tpu/fluxion/layers/embedding.py``."""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.layers.module import WeightedModule


class Embedding(WeightedModule):
    def __init__(self, num_embeddings: int, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = rng.init_normal((num_embeddings, embedding_dim), device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight)
