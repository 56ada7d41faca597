"""SAM's ViT image encoder; counterpart of
``refiners_tpu/foundationals/segment_anything/image_encoder.py``.

The encoder's inside is channels-last, as in the JAX package and the
reference PyTorch SAM: `PatchEncoder` permutes its NCHW convolution output to
(B, H, W, C) and `Neck` permutes back before its convolutions, so every
weighted module keeps the JAX package's class, order, key path and (after the
bridge's transposes) layout. The relative-position attention runs the
hand-written kernel (``ops.flash_attention.flash_attention_relpos``) on the
card, at every layer, and the JAX package's plain computation elsewhere.
"""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.utils import pad
from refiners_tpu_torch.ops import attention as attention_ops
from refiners_tpu_torch.ops.flash_attention import flash_attention_relpos


class PatchEncoder(fl.Chain):
    """Patch convolution, then NCHW → NHWC for the transformer."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        patch_size: int = 16,
        use_bias: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.patch_size = patch_size
        self.use_bias = use_bias
        super().__init__(
            fl.Conv2d(
                in_channels=in_channels,
                out_channels=out_channels,
                kernel_size=(patch_size, patch_size),
                stride=(patch_size, patch_size),
                use_bias=use_bias,
                device=device,
                dtype=dtype,
            ),
            fl.Permute(0, 2, 3, 1),
        )


class PositionalEncoder(fl.Residual):
    def __init__(
        self,
        embedding_dim: int,
        image_embedding_size: tuple[int, int],
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.image_embedding_size = image_embedding_size
        super().__init__(
            fl.Parameter(
                image_embedding_size[0], image_embedding_size[1], embedding_dim, device=device, dtype=dtype
            ),
        )


class RelativePositionAttention(fl.WeightedModule):
    """Attention over a fused (B, H, W, 3·C) projection with SAM's decomposed
    relative-position bias.

    q, k and v are strided head views of the projection (row stride 3·C, k
    starting C after q), which the kernel reads in place. With
    `is_optimized` (the default) the layer takes the kernel whenever
    `flash_auto_relpos` says so (on the card); otherwise it runs the JAX
    package's plain computation: float32 logits of the scaled query, the
    bias added as `(logits + v_rel) + h_rel` in float32, the softmax weights
    cast to the input dtype before the product with V.
    """

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        spatial_size: tuple[int, int],
        is_optimized: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.head_dim = embedding_dim // num_heads
        self.spatial_size = spatial_size
        self.is_optimized = is_optimized
        self.horizontal_embedding = rng.zeros((2 * spatial_size[0] - 1, self.head_dim), device=device, dtype=dtype)
        self.vertical_embedding = rng.zeros((2 * spatial_size[1] - 1, self.head_dim), device=device, dtype=dtype)

    @property
    def weight(self) -> torch.nn.Parameter:  # type: ignore[override]
        return self.horizontal_embedding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, height, width, _ = x.shape
        seq = height * width
        scale = self.head_dim**-0.5
        qkv = x.reshape(batch, seq, 3, self.num_heads, self.head_dim)
        query, key, value = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, L, D), no copy

        h_rel, v_rel = self.compute_relative_embedding(query)

        if self.is_optimized and attention_ops.flash_auto_relpos(query):
            # the (heads, L, L) float32 bias is 1 GiB per SAM-H global layer;
            # the kernel reads the decomposed terms (2 × 16 × 4096 × 64 values)
            out = flash_attention_relpos(
                query,
                key,
                value,
                v_rel=v_rel[..., 0].reshape(batch, self.num_heads, seq, -1).contiguous(),
                h_rel=h_rel[..., 0, :].reshape(batch, self.num_heads, seq, -1).contiguous(),
                scale=scale,
            )
        else:
            logits = torch.matmul((query * scale).float(), key.float().transpose(-1, -2))
            # the order of the additions is the JAX package's
            logits = (logits.reshape(-1, height, width, height, width) + v_rel.float()) + h_rel.float()
            weights = torch.softmax(logits.reshape(batch, self.num_heads, seq, seq), dim=-1).to(x.dtype)
            out = torch.matmul(weights, value)
        return out.transpose(1, 2).reshape(batch, height, width, -1)

    def compute_relative_coords(self, size: int) -> torch.Tensor:
        r = torch.arange(size, device=self.horizontal_embedding.device)
        return r[:, None] - r[None, :] + size - 1

    def compute_relative_embedding(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(h_rel, v_rel) of the query x (..., L, D), in its dtype:
        (B·heads, W, H, 1, kw) and (B·heads, W, H, kh, 1)."""
        width, height = self.spatial_size
        horizontal = self.horizontal_embedding[self.compute_relative_coords(width)].to(x.dtype)
        vertical = self.vertical_embedding[self.compute_relative_coords(height)].to(x.dtype)
        xg = x.reshape(-1, width, height, x.shape[-1])
        h_rel = torch.einsum("bhwc,wkc->bhwk", xg, horizontal)[..., None, :]
        v_rel = torch.einsum("bhwc,hkc->bhwk", xg, vertical)[..., None]
        return h_rel, v_rel


class FusedSelfAttention(fl.Chain):
    """qkv in one matmul, relative-position attention, output projection."""

    def __init__(
        self,
        embedding_dim: int = 768,
        spatial_size: tuple[int, int] = (64, 64),
        num_heads: int = 1,
        use_bias: bool = True,
        is_causal: bool = False,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        assert embedding_dim % num_heads == 0, f"Embedding dim {embedding_dim} not divisible by {num_heads} heads"
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.use_bias = use_bias
        self.is_causal = is_causal
        super().__init__(
            fl.Linear(
                in_features=embedding_dim, out_features=3 * embedding_dim, bias=use_bias, device=device, dtype=dtype
            ),
            RelativePositionAttention(
                embedding_dim=embedding_dim, num_heads=num_heads, spatial_size=spatial_size, device=device, dtype=dtype
            ),
            fl.Linear(in_features=embedding_dim, out_features=embedding_dim, bias=True, device=device, dtype=dtype),
        )


class FeedForward(fl.Chain):
    def __init__(self, embedding_dim: int, feedforward_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.embedding_dim = embedding_dim
        self.feedforward_dim = feedforward_dim
        super().__init__(
            fl.Linear(in_features=embedding_dim, out_features=feedforward_dim, bias=True, device=device, dtype=dtype),
            fl.GeLU(),
            fl.Linear(in_features=feedforward_dim, out_features=embedding_dim, bias=True, device=device, dtype=dtype),
        )


class WindowPartition(fl.ContextModule):
    """(B, H, W, C) → (B·windows, ws, ws, C), zero-padding H and W to window multiples."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, height, width, channels = x.shape
        context = self.use_context("window_partition")
        context.update({"original_height": height, "original_width": width})
        window_size = context["window_size"]
        padding_height = (window_size - height % window_size) % window_size
        padding_width = (window_size - width % window_size) % window_size
        if padding_height > 0 or padding_width > 0:
            x = pad(x, (0, 0, 0, padding_width, 0, padding_height))
        padded_height, padded_width = height + padding_height, width + padding_width
        context.update({"padded_height": padded_height, "padded_width": padded_width})
        x = x.reshape(
            batch, padded_height // window_size, window_size, padded_width // window_size, window_size, channels
        )
        return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, channels)


class WindowMerge(fl.ContextModule):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        context = self.use_context("window_partition")
        window_size = context["window_size"]
        padded_height, padded_width = context["padded_height"], context["padded_width"]
        original_height, original_width = context["original_height"], context["original_width"]
        batch_size = x.shape[0] // (padded_height * padded_width // window_size // window_size)
        x = x.reshape(
            batch_size, padded_height // window_size, padded_width // window_size, window_size, window_size, -1
        )
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(batch_size, padded_height, padded_width, -1)
        if padded_height > original_height or padded_width > original_width:
            x = x[:, :original_height, :original_width, :]
        return x


class TransformerLayer(fl.Chain):
    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        feedforward_dim: int,
        image_embedding_size: tuple[int, int],
        window_size: int | None = None,
        layer_norm_eps: float = 1e-6,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.feedforward_dim = feedforward_dim
        self.window_size = window_size
        self.layer_norm_eps = layer_norm_eps
        self.image_embedding_size = image_embedding_size
        attention_spatial_size = (window_size, window_size) if window_size is not None else image_embedding_size
        reshape_or_merge = (
            WindowMerge()
            if self.window_size is not None
            else fl.Reshape(image_embedding_size[0], image_embedding_size[1], embedding_dim)
        )
        super().__init__(
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=layer_norm_eps, device=device, dtype=dtype),
                WindowPartition() if self.window_size is not None else fl.Identity(),
                FusedSelfAttention(
                    embedding_dim=embedding_dim,
                    num_heads=num_heads,
                    spatial_size=attention_spatial_size,
                    device=device,
                    dtype=dtype,
                ),
                reshape_or_merge,
            ),
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=layer_norm_eps, device=device, dtype=dtype),
                FeedForward(embedding_dim=embedding_dim, feedforward_dim=feedforward_dim, device=device, dtype=dtype),
            ),
        )

    def init_context(self) -> Contexts:
        return {"window_partition": {"window_size": self.window_size}}


class Neck(fl.Chain):
    """NHWC → NCHW, then two convolutions, each followed by a LayerNorm2d."""

    def __init__(self, in_channels: int = 768, device: Any = None, dtype: Any = None) -> None:
        self.in_channels = in_channels
        super().__init__(
            fl.Permute(0, 3, 1, 2),
            fl.Conv2d(in_channels=in_channels, out_channels=256, kernel_size=1, use_bias=False, device=device, dtype=dtype),
            fl.LayerNorm2d(channels=256, device=device, dtype=dtype),
            fl.Conv2d(in_channels=256, out_channels=256, kernel_size=3, padding=1, use_bias=False, device=device, dtype=dtype),
            fl.LayerNorm2d(channels=256, device=device, dtype=dtype),
        )


class Transformer(fl.Chain):
    pass


class SAMViT(fl.Chain):
    """1024² images, patch 16, window 14, global attention at the chosen
    layers: (B, 3, 1024, 1024) → (B, 256, 64, 64)."""

    def __init__(
        self,
        embedding_dim: int,
        num_layers: int,
        num_heads: int,
        global_attention_indices: tuple[int, ...] | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.image_size = (1024, 1024)
        self.patch_size = 16
        self.window_size = 14
        self.image_embedding_size = (self.image_size[0] // self.patch_size, self.image_size[1] // self.patch_size)
        self.feed_forward_dim = 4 * self.embedding_dim
        self.global_attention_indices = global_attention_indices or tuple()
        super().__init__(
            PatchEncoder(
                in_channels=3, out_channels=embedding_dim, patch_size=self.patch_size, device=device, dtype=dtype
            ),
            PositionalEncoder(
                embedding_dim=embedding_dim, image_embedding_size=self.image_embedding_size, device=device, dtype=dtype
            ),
            Transformer(
                TransformerLayer(
                    embedding_dim=embedding_dim,
                    num_heads=num_heads,
                    feedforward_dim=self.feed_forward_dim,
                    window_size=self.window_size if i not in self.global_attention_indices else None,
                    image_embedding_size=self.image_embedding_size,
                    device=device,
                    dtype=dtype,
                )
                for i in range(num_layers)
            ),
            Neck(in_channels=embedding_dim, device=device, dtype=dtype),
        )


class SAMViTH(SAMViT):
    """ViT-H: 1280-dim, 32 layers, 16 heads, global attention at (7, 15, 23, 31)."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            embedding_dim=1280,
            num_layers=32,
            num_heads=16,
            global_attention_indices=(7, 15, 23, 31),
            device=device,
            dtype=dtype,
        )
