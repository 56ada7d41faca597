"""SAM's prompt encoders (points, boxes, masks); counterpart of
``refiners_tpu/foundationals/segment_anything/prompt_encoder.py``.

Dense embeddings are NCHW here, (B, C, H, W); the JAX package's are NHWC.
The point type mask stays on the host (a CPU tensor): the padding rule
branches on its values without a device round trip.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from enum import Enum, auto
from typing import Any

import numpy as np
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.context import Contexts


class CoordinateEncoder(fl.Chain):
    """Random-Fourier features of (x, y) coordinates in [0, 1]."""

    def __init__(
        self,
        num_positional_features: int = 64,
        scale: float = 1,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.num_positional_features = num_positional_features
        self.scale = scale
        super().__init__(
            fl.Multiply(scale=2, bias=-1),
            fl.Linear(in_features=2, out_features=num_positional_features, bias=False, device=device, dtype=dtype),
            fl.Multiply(scale=2 * math.pi * self.scale),
            fl.Concatenate(fl.Sin(), fl.Cos(), dim=-1),
        )


class PointType(Enum):
    BACKGROUND = auto()
    FOREGROUND = auto()
    BOX_TOP_LEFT = auto()
    BOX_BOTTOM_RIGHT = auto()
    NOT_A_POINT = auto()


class PointTypeEmbedding(fl.WeightedModule, fl.ContextModule):
    """One learned embedding per point type, selected by the type mask."""

    def __init__(self, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.weight = rng.init_normal((len(PointType), embedding_dim), device=device, dtype=dtype)

    def forward(self, type_mask: torch.Tensor) -> torch.Tensor:
        # type ids are 1-based; id 0 (unused) maps to zeros
        if type_mask.device != self.weight.device:
            # the prompt's mask, on the host: its rows picked by value (views, one stack), not uploaded
            zeros = self.weight.new_zeros(self.embedding_dim)
            rows = [self.weight[min(t, len(PointType)) - 1] if t > 0 else zeros for t in type_mask.flatten().tolist()]
            return torch.stack(rows).reshape(*type_mask.shape, self.embedding_dim)
        idx = (type_mask.long() - 1).clamp(0, len(PointType) - 1)
        return torch.where((type_mask > 0)[..., None], self.weight[idx], 0.0)


class PadPoints(fl.ContextModule):
    """Append a NOT_A_POINT pad token when no box is given."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = self.use_context("point_encoder")
        type_mask: torch.Tensor = context["type_mask"]
        has_box = bool(
            ((type_mask == PointType.BOX_TOP_LEFT.value) | (type_mask == PointType.BOX_BOTTOM_RIGHT.value)).any()
        )
        if has_box:
            return x
        pad_ids = torch.full((type_mask.shape[0], 1), PointType.NOT_A_POINT.value, dtype=type_mask.dtype)
        # write through the parent chain so that the update reaches its
        # sub-chains' providers (the Residual below reads the mask)
        parent = self.parent
        assert isinstance(parent, fl.Chain)
        parent.set_context("point_encoder", {"type_mask": torch.cat([type_mask, pad_ids.to(type_mask.device)], dim=1)})
        return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[-1]))], dim=1)


class PointEncoder(fl.Chain):
    def __init__(self, embedding_dim: int = 256, scale: float = 1, device: Any = None, dtype: Any = None) -> None:
        assert embedding_dim % 2 == 0, "embedding_dim must be divisible by 2."
        self.embedding_dim = embedding_dim
        self.scale = scale
        super().__init__(
            CoordinateEncoder(num_positional_features=embedding_dim // 2, scale=scale, device=device, dtype=dtype),
            PadPoints(),
            fl.Residual(
                fl.UseContext(context="point_encoder", key="type_mask"),
                PointTypeEmbedding(embedding_dim=embedding_dim, device=device, dtype=dtype),
            ),
        )

    def init_context(self) -> Contexts:
        return {"point_encoder": {"type_mask": None}}

    def set_type_mask(self, type_mask: torch.Tensor) -> None:
        self.set_context("point_encoder", {"type_mask": type_mask})

    def get_dense_positional_embedding(self, image_embedding_size: tuple[int, int]) -> torch.Tensor:
        """(1, C, H, W) positional embedding of the image embedding's grid."""
        coordinate_encoder = self.ensure_find(CoordinateEncoder)
        height, width = image_embedding_size
        grid = torch.ones((height, width), dtype=torch.float32, device=self.device)
        y_embedding = (torch.cumsum(grid, dim=0) - 0.5) / height
        x_embedding = (torch.cumsum(grid, dim=1) - 0.5) / width
        embedding = coordinate_encoder(torch.stack([x_embedding, y_embedding], dim=-1))  # (H, W, C)
        return embedding.permute(2, 0, 1)[None]

    def points_to_tensor(
        self,
        foreground_points: Sequence[tuple[float, float]] | None = None,
        background_points: Sequence[tuple[float, float]] | None = None,
        not_a_points: Sequence[tuple[float, float]] | None = None,
        box_points: Sequence[Sequence[tuple[float, float]]] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pack prompt points into (coordinates (1, P, 2) float32, type mask
        (1, P) int32), both on the host."""
        foreground_points = foreground_points or []
        background_points = background_points or []
        not_a_points = not_a_points or []
        box_points = box_points or []
        top_left_points = [box[0] for box in box_points]
        bottom_right_points = [box[1] for box in box_points]

        coordinates: list[np.ndarray] = []
        type_ids: list[np.ndarray] = []
        # in the order of the PointType enum
        for type_id, coords_seq in zip(
            PointType, [background_points, foreground_points, top_left_points, bottom_right_points, not_a_points]
        ):
            if len(coords_seq) > 0:
                coordinates.append(np.asarray(list(coords_seq), dtype=np.float32))
                type_ids.append(np.full((len(coords_seq),), type_id.value, dtype=np.int32))

        all_coordinates = torch.from_numpy(np.concatenate(coordinates, axis=0))[None]
        type_mask = torch.from_numpy(np.concatenate(type_ids, axis=0))[None]
        return all_coordinates, type_mask


class MaskEncoder(fl.Chain):
    """(B, 1, 256, 256) mask logits → (B, C, 64, 64) dense embedding."""

    def __init__(
        self,
        embedding_dim: int = 256,
        intermediate_channels: int = 16,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.intermediate_channels = intermediate_channels
        super().__init__(
            fl.Conv2d(
                in_channels=1, out_channels=intermediate_channels // 4, kernel_size=2, stride=2, device=device, dtype=dtype
            ),
            fl.LayerNorm2d(channels=intermediate_channels // 4, device=device, dtype=dtype),
            fl.GeLU(),
            fl.Conv2d(
                in_channels=intermediate_channels // 4,
                out_channels=intermediate_channels,
                kernel_size=2,
                stride=2,
                device=device,
                dtype=dtype,
            ),
            fl.LayerNorm2d(channels=intermediate_channels, device=device, dtype=dtype),
            fl.GeLU(),
            fl.Conv2d(in_channels=intermediate_channels, out_channels=embedding_dim, kernel_size=1, device=device, dtype=dtype),
        )
        self.no_mask_embedding = rng.init_normal((1, embedding_dim), device=device, dtype=dtype)

    def get_no_mask_dense_embedding(
        self, image_embedding_size: tuple[int, int], batch_size: int = 1
    ) -> torch.Tensor:
        """(B, C, H, W) dense embedding when no mask prompt is given."""
        return self.no_mask_embedding.reshape(1, -1, 1, 1).expand(
            batch_size, self.embedding_dim, image_embedding_size[0], image_embedding_size[1]
        )
