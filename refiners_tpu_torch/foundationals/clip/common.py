"""Shared CLIP blocks; counterpart of ``refiners_tpu/foundationals/clip/common.py``."""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl


class PositionalEncoder(fl.Chain):
    """Position ids 0..L-1 → Embedding."""

    def __init__(self, max_sequence_length: int, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.max_sequence_length = max_sequence_length
        self.embedding_dim = embedding_dim
        super().__init__(
            fl.Lambda(func=self.get_position_ids),
            fl.Embedding(num_embeddings=max_sequence_length, embedding_dim=embedding_dim, device=device, dtype=dtype),
        )

    @property
    def position_ids(self) -> torch.Tensor:
        """(1, max_sequence_length) position ids on the encoder's device."""
        return torch.arange(self.max_sequence_length, device=self.device).reshape(1, -1)

    def get_position_ids(self, x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device).reshape(1, -1)


class FeedForward(fl.Chain):
    """Linear → GeLU → Linear."""

    def __init__(self, embedding_dim: int, feedforward_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.embedding_dim = embedding_dim
        self.feedforward_dim = feedforward_dim
        super().__init__(
            fl.Linear(in_features=embedding_dim, out_features=feedforward_dim, device=device, dtype=dtype),
            fl.GeLU(),
            fl.Linear(in_features=feedforward_dim, out_features=embedding_dim, device=device, dtype=dtype),
        )
