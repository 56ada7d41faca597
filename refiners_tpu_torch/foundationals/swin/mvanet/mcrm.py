"""MCRM, multi-view complementary refinement; counterpart of
``refiners_tpu/foundationals/swin/mvanet/mcrm.py``.

Multi-view stacks are (B, V, C, H, W).
"""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.foundationals.swin.mvanet.utils import (
    FeedForward,
    Interpolate,
    MultiPool,
    PatchMerge,
    PatchSplit,
    PatchwiseCrossAttention,
    Unflatten,
)


class Multiply(fl.Chain):
    """The product of its two children's outputs."""

    def __init__(self, o1: fl.Module, o2: fl.Module) -> None:
        super().__init__(o1, o2)

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        return self[0](*args) * self[1](*args)


class TiledCrossAttention(fl.Chain):
    """Input: the (local, global) pair; each local tile attends to its
    quadrant of the global view, pooled at `pool_ratios`."""

    def __init__(
        self,
        emb_dim: int,
        dim: int,
        num_heads: int = 1,
        pool_ratios: list[int] | None = None,
        device: Any = None,
    ) -> None:
        if pool_ratios is None:
            pool_ratios = [1, 2, 4]

        super().__init__(
            fl.Distribute(
                fl.Chain(  # local (B, 4, C, h, w) → (4, hw, B, C)
                    fl.Flatten(3, 4),
                    fl.Permute(1, 3, 0, 2),
                ),
                fl.Chain(  # global → pooled sequences
                    PatchSplit(),
                    fl.Squeeze(0),
                    MultiPool(pool_ratios),
                ),
            ),
            fl.Sum(
                fl.Chain(
                    fl.GetArg(0),
                    fl.Permute(2, 1, 0, 3),  # (B, hw, 4, C)
                ),
                fl.Chain(
                    PatchwiseCrossAttention(emb_dim, num_heads, device=device),
                    fl.Permute(2, 1, 0, 3),
                ),
            ),
            fl.LayerNorm(emb_dim, device=device),
            FeedForward(emb_dim, device=device),
            fl.LayerNorm(emb_dim, device=device),
            fl.Permute(0, 2, 3, 1),  # (B, 4, C, hw)
            Unflatten(3, (dim, dim)),  # (B, 4, C, h, w)
        )


class MCRM(fl.Chain):
    """Refine the local views from the global one and fold them back into it."""

    def __init__(
        self,
        emb_dim: int,
        size: int,
        num_heads: int = 1,
        pool_ratios: list[int] | None = None,
        device: Any = None,
    ) -> None:
        if pool_ratios is None:
            pool_ratios = [1, 2, 4]

        super().__init__(
            fl.Parallel(
                fl.Chain(fl.Slicing(dim=1, end=4)),  # local
                fl.Chain(fl.Slicing(dim=1, start=4), fl.Squeeze(1)),  # global
            ),
            fl.Parallel(
                Multiply(
                    fl.GetArg(0),
                    fl.Chain(
                        fl.GetArg(1),
                        fl.Conv2d(emb_dim, 1, 1, device=device),
                        fl.Sigmoid(),
                        Interpolate((size * 2, size * 2), "nearest"),
                        PatchSplit(),
                    ),
                ),
                fl.GetArg(1),
            ),
            fl.Parallel(
                TiledCrossAttention(emb_dim, size, num_heads, pool_ratios, device=device),
                fl.GetArg(1),
            ),
            fl.Concatenate(
                fl.GetArg(0),
                fl.Chain(
                    fl.Sum(
                        fl.GetArg(1),
                        fl.Chain(
                            fl.GetArg(0),
                            PatchMerge(),
                            Interpolate((size, size), "nearest"),
                        ),
                    ),
                    fl.Unsqueeze(1),
                ),
                dim=1,
            ),
        )
