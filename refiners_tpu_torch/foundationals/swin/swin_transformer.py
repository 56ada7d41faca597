"""Swin Transformer (arXiv:2103.14030), as MVANet uses it, on square inputs;
counterpart of ``refiners_tpu/foundationals/swin/swin_transformer.py``.

The image is NCHW; inside, tokens are (B, L, C) sequences and the windowed
blocks work on (B, H, W, C) grids, as in the JAX package. The five-level
``swin/outputs`` pyramid is stored NCHW. Window attention (at most 144
tokens) is plain PyTorch: float32 logits plus the relative-position bias and
the shifted-window mask, as the JAX package's XLA attention computes them.
"""

from __future__ import annotations

import functools
from math import isqrt
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.ops.attention import _attention


def to_windows(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) → (B, windows, ws², C), windows in row-major order."""
    B, H, W, C = x.shape
    assert W == H and H % window_size == 0
    x = x.reshape(B, H // window_size, window_size, W // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, window_size * window_size, C)


class ToWindows(fl.Module):
    def __init__(self, window_size: int) -> None:
        super().__init__()
        self.window_size = window_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_windows(x, self.window_size)


class FromWindows(fl.Module):
    """(B, windows, ws², C) → (B, H, W, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, num_windows, window_size_2, C = x.shape
        window_size = isqrt(window_size_2)
        H = isqrt(num_windows * window_size_2)
        x = x.reshape(B, H // window_size, H // window_size, window_size, window_size, C)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, H, C)


@functools.cache
def get_attn_mask(H: int, window_size: int) -> np.ndarray:
    """The shifted-window mask, (windows, ws², ws²): 0 within a region,
    -100 across regions."""
    assert H % window_size == 0
    shift_size = window_size // 2
    img_mask = np.zeros((1, H, H, 1), dtype=np.float32)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size), slice(-shift_size, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    hw = H // window_size
    mask_windows = (
        img_mask.reshape(1, hw, window_size, hw, window_size, 1)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(hw * hw, window_size * window_size)
    )
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@functools.cache
def _attn_mask_on(H: int, window_size: int, device: torch.device) -> torch.Tensor:
    """`get_attn_mask` as a tensor on `device`, copied there once."""
    return torch.from_numpy(get_attn_mask(H, window_size)).to(device)


class Pad(fl.Module):
    """Zero-pad a square (B, H, W, C) grid at its bottom and right to a multiple of `step`."""

    def __init__(self, step: int) -> None:
        super().__init__()
        self.step = step

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        assert W == H
        if H % self.step == 0:
            return x
        p = self.step * ((H + self.step - 1) // self.step)
        return F.pad(x, (0, 0, 0, p - H, 0, p - H))


class StatefulPad(fl.Chain):
    """`Pad`, pushing the size before padding onto ``contexts[context][key]``."""

    def __init__(self, context: str, key: str, step: int) -> None:
        super().__init__(
            fl.SetContext(context=context, key=key, callback=self._push),
            Pad(step=step),
        )

    def _push(self, sizes: list[int], x: torch.Tensor) -> None:
        sizes.append(x.shape[1])


class StatefulUnpad(fl.Chain):
    """Crop back to the size `StatefulPad` pushed last."""

    def __init__(self, context: str, key: str) -> None:
        super().__init__(
            fl.Parallel(
                fl.Identity(),
                fl.UseContext(context=context, key=key).compose(lambda x: x.pop()),
            ),
            fl.Lambda(self._unpad),
        )

    @staticmethod
    def _unpad(x: torch.Tensor, size: int) -> torch.Tensor:
        return x[:, :size, :size, :]


class SquareUnflatten(fl.Module):
    """..., L², ... → ..., L, L, ..."""

    def __init__(self, dim: int = 0) -> None:
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = isqrt(x.shape[self.dim])
        return x.unflatten(self.dim, (d, d))


class WindowUnflatten(fl.Module):
    """..., H, ... → ..., H // ws, ws, ..."""

    def __init__(self, window_size: int, dim: int = 0) -> None:
        super().__init__()
        self.window_size = window_size
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = x.shape[self.dim]
        assert H % self.window_size == 0
        return x.unflatten(self.dim, (H // self.window_size, self.window_size))


class Roll(fl.Module):
    """`torch.roll` by (dim, shift) pairs."""

    def __init__(self, *shifts: tuple[int, int]) -> None:
        super().__init__()
        self.shifts = shifts
        self._dims = tuple(s[0] for s in shifts)
        self._shifts = tuple(s[1] for s in shifts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.roll(x, self._shifts, self._dims)


def _relative_position_index(window_size: int) -> np.ndarray:
    """The (ws², ws²) index of each query-key offset into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(window_size), np.arange(window_size), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1).astype(np.int64)


class RelativePositionBias(fl.Module):
    """The learned ((2 ws - 1)², heads) table gathered by the index, a
    persistent buffer under the JAX package's key."""

    relative_position_index: torch.Tensor

    def __init__(self, window_size: int, num_heads: int, device: Any = None) -> None:
        super().__init__()
        self.relative_position_bias_table = rng.init_normal(
            ((2 * window_size - 1) * (2 * window_size - 1), num_heads), std=0.02, device=device
        )
        self.register_buffer(
            "relative_position_index", torch.from_numpy(_relative_position_index(window_size)).to(device)
        )

    def forward(self) -> torch.Tensor:
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.permute(2, 0, 1)[None]  # (1, heads, ws², ws²)


class WindowSDPA(fl.Module):
    """Attention within each window over a fused (B, windows, ws², 3C) projection."""

    def __init__(self, window_size: int, num_heads: int, shift: bool = False, device: Any = None) -> None:
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.shift = shift
        self.rpb = RelativePositionBias(window_size, num_heads, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, num_windows, N, _C = x.shape
        assert _C % (3 * self.num_heads) == 0
        C = _C // 3
        qkv = x.reshape(B, num_windows, N, 3, self.num_heads, C // self.num_heads).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, windows, heads, N, d)

        attn_mask = self.rpb()[None]  # (1, 1, heads, N, N)
        if self.shift:
            mask = _attn_mask_on(isqrt(num_windows * self.window_size**2), self.window_size, x.device)
            attn_mask = attn_mask + mask[None, :, None]

        out = _attention(q, k, v, mask=attn_mask.float())
        return out.permute(0, 1, 3, 2, 4).reshape(B, num_windows, N, C)


class WindowAttention(fl.Chain):
    """W-MSA / SW-MSA with relative position bias; fused qkv projection."""

    def __init__(self, dim: int, window_size: int, num_heads: int, shift: bool = False, device: Any = None) -> None:
        super().__init__(
            fl.Linear(dim, dim * 3, bias=True, device=device),
            WindowSDPA(window_size, num_heads, shift, device=device),
            fl.Linear(dim, dim, device=device),
        )


class SwinTransformerBlock(fl.Chain):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: int = 7,
        shift_size: int = 0,
        mlp_ratio: float = 4.0,
        device: Any = None,
    ) -> None:
        assert 0 <= shift_size < window_size, "shift_size must be in [0, window_size["
        super().__init__(
            fl.Residual(
                fl.LayerNorm(dim, device=device),
                SquareUnflatten(1),
                StatefulPad(context="padding", key="sizes", step=window_size),
                Roll((1, -shift_size), (2, -shift_size)),
                ToWindows(window_size),
                WindowAttention(dim, window_size=window_size, num_heads=num_heads, shift=shift_size > 0, device=device),
                FromWindows(),
                Roll((1, shift_size), (2, shift_size)),
                StatefulUnpad(context="padding", key="sizes"),
                fl.Flatten(1, 2),
            ),
            fl.Residual(
                fl.LayerNorm(dim, device=device),
                fl.Linear(dim, int(dim * mlp_ratio), device=device),
                fl.GeLU(),
                fl.Linear(int(dim * mlp_ratio), dim, device=device),
            ),
        )

    def init_context(self) -> Contexts:
        return {"padding": {"sizes": []}}


class PatchMerging(fl.Chain):
    """(B, H·W, C) → (B, H·W / 4, 2C): 2 × 2 neighbours concatenated, normalized, projected."""

    def __init__(self, dim: int, device: Any = None) -> None:
        super().__init__(
            SquareUnflatten(1),
            Pad(2),
            WindowUnflatten(2, 2),
            WindowUnflatten(2, 1),
            fl.Permute(0, 1, 3, 4, 2, 5),
            fl.Flatten(3),
            fl.Flatten(1, 2),
            fl.LayerNorm(4 * dim, device=device),
            fl.Linear(4 * dim, 2 * dim, bias=False, device=device),
        )


class BasicLayer(fl.Chain):
    """`depth` blocks, every second one on shifted windows."""

    def __init__(
        self,
        dim: int,
        depth: int,
        num_heads: int,
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        device: Any = None,
    ) -> None:
        super().__init__(
            SwinTransformerBlock(
                dim=dim,
                num_heads=num_heads,
                window_size=window_size,
                shift_size=0 if (i % 2 == 0) else window_size // 2,
                mlp_ratio=mlp_ratio,
                device=device,
            )
            for i in range(depth)
        )


class PatchEmbedding(fl.Chain):
    """NCHW image → (B, h·w, C) normalized patch tokens."""

    def __init__(
        self,
        patch_size: tuple[int, int] = (4, 4),
        in_chans: int = 3,
        embedding_dim: int = 96,
        device: Any = None,
    ) -> None:
        super().__init__(
            fl.Conv2d(in_chans, embedding_dim, kernel_size=patch_size, stride=patch_size, device=device),
            fl.Flatten(2),  # (B, C, h·w)
            fl.Transpose(1, 2),  # (B, h·w, C)
            fl.LayerNorm(embedding_dim, device=device),
        )


class SwinTransformer(fl.Chain):
    """Swin backbone: a tuple of five NCHW maps, coarsest first (the last
    layer's, then each earlier layer's, then the patch embedding's)."""

    def __init__(
        self,
        patch_size: tuple[int, int] = (4, 4),
        in_chans: int = 3,
        embedding_dim: int = 96,
        depths: list[int] | None = None,
        num_heads: list[int] | None = None,
        window_size: int = 7,  # image size is 32 * this
        mlp_ratio: float = 4.0,
        device: Any = None,
    ) -> None:
        if depths is None:
            depths = [2, 2, 6, 2]
        if num_heads is None:
            num_heads = [3, 6, 12, 24]
        self.num_layers = len(depths)
        assert len(num_heads) == self.num_layers

        super().__init__(
            PatchEmbedding(patch_size=patch_size, in_chans=in_chans, embedding_dim=embedding_dim, device=device),
            fl.Passthrough(
                SquareUnflatten(1),
                fl.Permute(0, 3, 1, 2),
                fl.SetContext("swin", "outputs", callback=lambda t, x: t.append(x)),
            ),
            *(
                fl.Chain(
                    BasicLayer(
                        dim=int(embedding_dim * 2**i),
                        depth=depths[i],
                        num_heads=num_heads[i],
                        window_size=window_size,
                        mlp_ratio=mlp_ratio,
                        device=device,
                    ),
                    fl.Passthrough(
                        fl.LayerNorm(int(embedding_dim * 2**i), device=device),
                        SquareUnflatten(1),
                        fl.Permute(0, 3, 1, 2),
                        fl.SetContext("swin", "outputs", callback=lambda t, x: t.insert(0, x)),
                    ),
                    PatchMerging(dim=int(embedding_dim * 2**i), device=device)
                    if i < self.num_layers - 1
                    else fl.UseContext("swin", "outputs").compose(lambda t: tuple(t)),
                )
                for i in range(self.num_layers)
            ),
        )

    def init_context(self) -> Contexts:
        return {"swin": {"outputs": []}}
