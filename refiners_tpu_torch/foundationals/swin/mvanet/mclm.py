"""MCLM, multi-view complementary localization; counterpart of
``refiners_tpu/foundationals/swin/mvanet/mclm.py``.

Multi-view stacks are (B, V, C, H, W); attention sequences are seq-first.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.swin.mvanet.utils import (
    FeedForward,
    MultiheadAttention,
    MultiPool,
    PatchMerge,
    PatchwiseCrossAttention,
    Unflatten,
)


class PerPixel(fl.Chain):
    """(B, C, H, W) → (H·W, B, C)."""

    def __init__(self) -> None:
        super().__init__(
            fl.Permute(2, 3, 0, 1),
            fl.Flatten(0, 1),
        )


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """`t` in page-locked memory on a CUDA machine: its copy to the card is
    one a compiled program's capture can hold (an unpinned one it cannot)."""
    return t.pin_memory() if torch.cuda.is_available() else t


def _dim_t(num_pos_feats: int) -> np.ndarray:
    t = np.arange(0, num_pos_feats, dtype=np.float32)
    return 10000 ** (2 * (t // 2) / num_pos_feats)


@functools.cache
def _sine_embedding(num_pos_feats: int, h: int, w: int) -> torch.Tensor:
    """DETR's sine embedding of an (h, w) grid, (h·w, 1, C), computed once on the host."""
    dim_t = _dim_t(num_pos_feats)
    y_embed = np.cumsum(np.ones((1, h, w, 1), dtype=np.float32), axis=1)
    x_embed = np.cumsum(np.ones((1, h, w, 1), dtype=np.float32), axis=2)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale

    pos_x = x_embed / dim_t
    pos_y = y_embed / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, :, 0::2]), np.cos(pos_x[:, :, :, 1::2])), axis=4).reshape(1, h, w, -1)
    pos_y = np.stack((np.sin(pos_y[:, :, :, 0::2]), np.cos(pos_y[:, :, :, 1::2])), axis=4).reshape(1, h, w, -1)
    pos = np.concatenate((pos_y, pos_x), axis=3)  # (1, h, w, C)
    return _pinned(torch.from_numpy(np.ascontiguousarray(pos.transpose(1, 2, 0, 3).reshape(h * w, 1, -1))))


@functools.cache
def _pool_embeddings(num_pos_feats: int, pool_ratios: tuple[int, ...], h: int, w: int) -> torch.Tensor:
    return _pinned(torch.cat([_sine_embedding(num_pos_feats, h // r, w // r) for r in pool_ratios]))


class PositionEmbeddingSine(fl.Module):
    """DETR's fixed sine position embedding of an (h, w) grid, (h·w, 1, C), on the host."""

    def __init__(self, num_pos_feats: int) -> None:
        super().__init__()
        self.num_pos_feats = num_pos_feats

    @property
    def dim_t(self) -> np.ndarray:
        return _dim_t(self.num_pos_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        return _sine_embedding(self.num_pos_feats, h, w)


class MultiPoolPos(fl.Module):
    """The position embeddings of `MultiPool`'s grids, concatenated."""

    def __init__(self, pool_ratios: list[int], positional_embedding: PositionEmbeddingSine) -> None:
        super().__init__()
        self.pool_ratios = pool_ratios
        self.positional_embedding = positional_embedding

    def forward(self, *args: int) -> torch.Tensor:
        h, w = args
        return _pool_embeddings(self.positional_embedding.num_pos_feats, tuple(self.pool_ratios), h, w)


class Repeat(fl.Module):
    """Repeat each element `n` times along `dim`."""

    def __init__(self, dim: int = 0) -> None:
        self.dim = dim
        super().__init__()

    def forward(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return torch.repeat_interleave(x, n, dim=self.dim)


class _MHA_Arg(fl.Sum):
    def __init__(self, offset: int) -> None:
        self.offset = offset
        super().__init__(
            fl.GetArg(offset),  # value
            fl.Chain(
                fl.Parallel(
                    fl.GetArg(self.offset + 1),  # position embedding
                    fl.Lambda(self._batch_size),
                ),
                Repeat(1),
            ),
        )

    def _batch_size(self, *args: torch.Tensor) -> int:
        return args[self.offset].shape[1]


class GlobalAttention(fl.Chain):
    """Input: (global, its position embedding, pools, their position embedding)."""

    def __init__(self, emb_dim: int, num_heads: int = 1, device: Any = None) -> None:
        super().__init__(
            fl.Sum(
                fl.GetArg(0),  # global
                fl.Chain(
                    fl.Parallel(
                        _MHA_Arg(0),  # Q: global + pos emb
                        _MHA_Arg(2),  # K: pools + pos emb
                        fl.GetArg(2),  # V: pools
                    ),
                    MultiheadAttention(emb_dim, num_heads, device=device),
                ),
            ),
        )


def _proxy(module: fl.Module) -> fl.Lambda:
    """Call `module` from a second place in the tree without registering it
    there: its weights keep one key."""

    def call(x: torch.Tensor) -> torch.Tensor:
        return module(x)

    return fl.Lambda(call)


class MCLM(fl.Chain):
    """(b, 5, e, 16, 16) → (b, 5, e, 16, 16), batch 1."""

    def __init__(
        self,
        emb_dim: int,
        num_heads: int = 1,
        pool_ratios: list[int] | None = None,
        device: Any = None,
    ) -> None:
        if pool_ratios is None:
            pool_ratios = [2, 8, 16]

        positional_embedding = PositionEmbeddingSine(num_pos_feats=emb_dim // 2)

        # the two LayerNorms are shared: present once in the tree, called
        # a second time through a proxy
        ln1 = fl.LayerNorm(emb_dim, device=device)
        ln2 = fl.LayerNorm(emb_dim, device=device)

        super().__init__(
            fl.Parallel(
                fl.Chain(  # global view
                    fl.Slicing(dim=1, start=4),
                    fl.Squeeze(1),
                    fl.Parallel(
                        PerPixel(),  # glb
                        fl.Chain(  # g_pos
                            fl.Lambda(lambda x: tuple(x.shape[2:4])),
                            positional_embedding,
                        ),
                    ),
                ),
                fl.Chain(  # local views
                    fl.Slicing(dim=1, end=4),
                    fl.SetContext("mclm", "local"),
                    PatchMerge(),
                    fl.Parallel(
                        fl.Chain(  # pool
                            MultiPool(pool_ratios),
                            fl.Squeeze(0),
                        ),
                        fl.Chain(  # pool_pos
                            fl.Lambda(lambda x: tuple(x.shape[2:4])),
                            MultiPoolPos(pool_ratios, positional_embedding),
                        ),
                    ),
                ),
            ),
            fl.Lambda(lambda t1, t2: (*t1, *t2)),
            fl.Converter(set_dtype=False),
            GlobalAttention(emb_dim, num_heads, device=device),
            ln1,
            FeedForward(emb_dim, device=device),
            ln2,
            fl.SetContext("mclm", "global"),
            fl.UseContext("mclm", "local"),
            fl.Flatten(3, 4),  # (b, 4, e, hw)
            fl.Permute(1, 3, 0, 2),  # (4, hw, b, e)
            fl.Residual(
                fl.Parallel(
                    fl.Identity(),
                    fl.Chain(
                        fl.UseContext("mclm", "global"),
                        Unflatten(0, (2, 8, 2, 8)),  # 2, h/2, 2, h/2
                        fl.Permute(0, 2, 1, 3, 4, 5),
                        fl.Flatten(0, 1),
                        fl.Flatten(1, 2),
                    ),
                ),
                PatchwiseCrossAttention(emb_dim, num_heads, device=device),
            ),
            _proxy(ln1),
            FeedForward(emb_dim, device=device),
            _proxy(ln2),
            fl.Concatenate(
                fl.Identity(),
                fl.Chain(
                    fl.UseContext("mclm", "global"),
                    fl.Unsqueeze(0),
                ),
            ),
            Unflatten(1, (16, 16)),  # (5, h, h, b, e)
            fl.Permute(3, 0, 4, 1, 2),  # (b, 5, e, h, h)
        )

    def init_context(self) -> Contexts:
        return {"mclm": {"global": None, "local": None}}
