"""DINOv2's ViT backbone; counterpart of
``refiners_tpu/foundationals/dinov2/vit.py``.

Images are NCHW: the patch convolution gives (B, D, h, w), flattened and
transposed to (B, h·w, D) tokens (the JAX package's channels-last output is
already in that order). Those layers hold no weights, so the key paths are
the JAX package's. At 518² the sequence is 37² + 1 = 1370 tokens (1374 with
four registers), so on the card every layer's self-attention takes the flash
kernel (``fl.SelfAttention``, ``FLASH_MIN_SEQ``); at 224² (257 tokens) it
stays on the plain path.
"""

from __future__ import annotations

from math import isqrt
from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.layers.activations import Activation
from refiners_tpu_torch.fluxion.utils import interpolate


class ClassToken(fl.Chain):
    """The learned class token, (B, 1, D) whatever the input."""

    def __init__(self, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.embedding_dim = embedding_dim
        super().__init__(fl.Parameter(1, embedding_dim, device=device, dtype=dtype))


class PositionalEmbedding(fl.Chain):
    """The learned (1 + P², D) position table, broadcast over the batch."""

    def __init__(
        self, sequence_length: int, embedding_dim: int, patch_size: int, device: Any = None, dtype: Any = None
    ) -> None:
        self.sequence_length = sequence_length
        self.embedding_dim = embedding_dim
        self.patch_size = patch_size
        super().__init__(fl.Parameter(sequence_length, embedding_dim, device=device, dtype=dtype))


class InterpolateEmbedding(fl.Module):
    """Resize the patch positions to the input's patch grid, in float32.

    The grid's rows follow the image's height and its columns the width,
    read in the JAX package's order (its W, H are the input's dims 1 and 2,
    which are the height and width of an NHWC image, as they are dims 2 and
    3 of an NCHW one here)."""

    def __init__(self, mode: str, antialias: bool, patch_size: int) -> None:
        super().__init__()
        self.mode = mode
        self.antialias = antialias
        self.patch_size = patch_size

    def forward(self, x: torch.Tensor, input: torch.Tensor) -> torch.Tensor:
        cls_embed = x[:, :1, :]
        patch_embed = x[:, 1:, :]

        B, N, D = patch_embed.shape
        M = isqrt(N)
        assert M * M == N, "The sequence length must be a square number."
        W, H = input.shape[2], input.shape[3]
        w, h = W // self.patch_size, H // self.patch_size

        grid = patch_embed.reshape(B, M, M, D).permute(0, 3, 1, 2)  # (B, D, M, M)
        grid = interpolate(grid.float(), (w, h), mode=self.mode, antialias=self.antialias)
        grid = grid.to(cls_embed.dtype).flatten(2).transpose(1, 2)  # (B, w·h, D)
        return torch.cat((cls_embed, grid), dim=1)


class LayerScale(fl.WeightedModule):
    """A learned per-channel scale."""

    def __init__(self, embedding_dim: int, init_value: float = 1.0, dtype: Any = None, device: Any = None) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.weight = torch.nn.Parameter(
            torch.full((embedding_dim,), init_value, device=device, dtype=dtype or torch.float32)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype)


class FeedForward(fl.Chain):
    """Linear, activation, Linear; a GLU activation doubles the first width."""

    def __init__(
        self,
        embedding_dim: int,
        feedforward_dim: int,
        activation: Activation,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.feedforward_dim = feedforward_dim
        pre_activation_dim = feedforward_dim * 2 if isinstance(activation, fl.GLU) else feedforward_dim
        super().__init__(
            fl.Linear(in_features=embedding_dim, out_features=pre_activation_dim, device=device, dtype=dtype),
            activation,
            fl.Linear(in_features=feedforward_dim, out_features=embedding_dim, device=device, dtype=dtype),
        )


class PatchEncoder(fl.Chain):
    """NCHW image → (B, h·w, D) patch tokens; records the input in the
    ``dinov2_vit`` context for the position interpolation."""

    def __init__(
        self, in_channels: int, out_channels: int, patch_size: int, device: Any = None, dtype: Any = None
    ) -> None:
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.patch_size = patch_size
        super().__init__(
            fl.SetContext(context="dinov2_vit", key="input"),
            fl.Conv2d(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=patch_size,
                stride=patch_size,
                device=device,
                dtype=dtype,
            ),  # (B, D, h, w)
            fl.Flatten(start_dim=2),  # (B, D, h·w)
            fl.Transpose(1, 2),  # (B, h·w, D)
        )


class TransformerLayer(fl.Chain):
    """Pre-norm self-attention and feed-forward, each scaled by a LayerScale."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        norm_eps: float,
        mlp_ratio: int,
        activation: Activation,
        feedforward_dim: int | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.mlp_ratio = mlp_ratio
        self.feedforward_dim = feedforward_dim if feedforward_dim is not None else embedding_dim * mlp_ratio
        super().__init__(
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=norm_eps, device=device, dtype=dtype),
                fl.SelfAttention(embedding_dim=embedding_dim, num_heads=num_heads, device=device, dtype=dtype),
                LayerScale(embedding_dim=embedding_dim, device=device, dtype=dtype),
            ),
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=norm_eps, device=device, dtype=dtype),
                FeedForward(
                    embedding_dim=embedding_dim,
                    feedforward_dim=self.feedforward_dim,
                    activation=activation,
                    device=device,
                    dtype=dtype,
                ),
                LayerScale(embedding_dim=embedding_dim, device=device, dtype=dtype),
            ),
        )


class Transformer(fl.Chain):
    """A Chain of TransformerLayers."""


class PositionalEncoder(fl.Residual):
    """Adds the (interpolated) position table."""


class Registers(fl.Concatenate):
    """Register tokens between the class token and the patches."""

    def __init__(self, num_registers: int, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.num_registers = num_registers
        self.embedding_dim = embedding_dim
        super().__init__(
            fl.Slicing(dim=1, end=1),
            fl.Parameter(num_registers, embedding_dim, device=device, dtype=dtype),
            fl.Slicing(dim=1, start=1),
            dim=1,
        )


class ViT(fl.Chain):
    """Vision Transformer whose position table is interpolated to the input's
    patch grid; returns (B, 1 + registers + h·w, D) normalized tokens."""

    def __init__(
        self,
        embedding_dim: int = 768,
        patch_size: int = 16,
        image_size: int = 224,
        num_layers: int = 12,
        num_heads: int = 12,
        norm_eps: float = 1e-6,
        mlp_ratio: int = 4,
        num_registers: int = 0,
        activation: Activation | None = None,
        feedforward_dim: int | None = None,
        interpolate_antialias: bool = False,
        interpolate_mode: str = "bicubic",
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        activation = activation if activation is not None else fl.GeLU()
        num_patches = image_size // patch_size
        self.embedding_dim = embedding_dim
        self.patch_size = patch_size
        self.image_size = image_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.norm_eps = norm_eps
        self.mlp_ratio = mlp_ratio
        self.num_registers = num_registers
        self.feedforward_dim = feedforward_dim

        super().__init__(
            fl.Concatenate(
                ClassToken(embedding_dim=embedding_dim, device=device, dtype=dtype),
                PatchEncoder(
                    in_channels=3, out_channels=embedding_dim, patch_size=patch_size, device=device, dtype=dtype
                ),
                dim=1,
            ),
            PositionalEncoder(
                PositionalEmbedding(
                    sequence_length=num_patches**2 + 1,
                    embedding_dim=embedding_dim,
                    patch_size=patch_size,
                    device=device,
                    dtype=dtype,
                ),
                fl.Chain(
                    fl.Parallel(
                        fl.Identity(),
                        fl.UseContext(context="dinov2_vit", key="input"),
                    ),
                    InterpolateEmbedding(mode=interpolate_mode, antialias=interpolate_antialias, patch_size=patch_size),
                ),
            ),
            Transformer(
                TransformerLayer(
                    embedding_dim=embedding_dim,
                    feedforward_dim=feedforward_dim,
                    activation=activation,
                    num_heads=num_heads,
                    mlp_ratio=mlp_ratio,
                    norm_eps=norm_eps,
                    device=device,
                    dtype=dtype,
                )
                for _ in range(num_layers)
            ),
            fl.LayerNorm(normalized_shape=embedding_dim, eps=norm_eps, device=device, dtype=dtype),
        )

        if self.num_registers > 0:
            registers = Registers(num_registers=num_registers, embedding_dim=embedding_dim, device=device, dtype=dtype)
            self.insert_before_type(Transformer, registers)

    def init_context(self) -> Contexts:
        return {"dinov2_vit": {"input": None}}
