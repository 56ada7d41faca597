"""SAM's mask decoder (tokens, two-way transformer, hypernetworks); counterpart
of ``refiners_tpu/foundationals/segment_anything/mask_decoder.py``.

Dense embeddings arrive NCHW, (B, C, H, W), and are flattened to (B, H·W, C)
sequences; the upscaled dense embedding is (B, C/8, 4H·4W), which an NCHW
tensor gives by flattening, with no transpose.
"""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.segment_anything.transformer import (
    SparseCrossDenseAttention,
    TwoWayTransformerLayer,
)


class EmbeddingsAggregator(fl.ContextModule):
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        mask_decoder = self.ensure_parent
        ctx = mask_decoder.use_context("mask_decoder")
        image_embedding = ctx["image_embedding"]  # (B, C, H, W)
        point_embedding = ctx["point_embedding"]
        mask_embedding = ctx["mask_embedding"]
        dense_positional_embedding = ctx["dense_positional_embedding"]

        sparse_embedding = torch.cat((tokens, point_embedding), dim=1)
        dense_embedding = (image_embedding + mask_embedding).flatten(2).transpose(1, 2)  # (B, HW, C)
        if dense_positional_embedding.shape != dense_embedding.shape:
            dense_positional_embedding = dense_positional_embedding.flatten(2).transpose(1, 2)

        ctx.update(
            {
                "dense_embedding": dense_embedding,
                "dense_positional_embedding": dense_positional_embedding,
                "sparse_embedding": sparse_embedding,
            }
        )
        mask_decoder.set_context("mask_decoder", ctx)
        return sparse_embedding


class Transformer(fl.Chain):
    pass


class Hypernetworks(fl.Concatenate):
    """One 3-layer MLP per mask token."""

    def __init__(
        self,
        embedding_dim: int = 256,
        num_layers: int = 3,
        num_mask_tokens: int = 4,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_layers = num_layers
        self.num_mask_tokens = num_mask_tokens
        super().__init__(
            *[
                fl.Chain(
                    fl.Slicing(dim=1, start=i, end=i + 1),
                    fl.MultiLinear(
                        input_dim=embedding_dim,
                        output_dim=embedding_dim // 8,
                        inner_dim=embedding_dim,
                        num_layers=num_layers,
                        device=device,
                        dtype=dtype,
                    ),
                )
                for i in range(num_mask_tokens)
            ],
            dim=1,
        )


class DenseEmbeddingUpscaling(fl.Chain):
    """(B, H·W, C) dense embedding → (B, C/8, 4H·4W) through two transposed convolutions."""

    def __init__(
        self,
        embedding_dim: int = 256,
        dense_embedding_side_dim: int = 64,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.dense_embedding_side_dim = dense_embedding_side_dim
        super().__init__(
            fl.UseContext(context="mask_decoder", key="dense_embedding"),  # (B, HW, C)
            fl.Transpose(1, 2),
            fl.Reshape(embedding_dim, dense_embedding_side_dim, dense_embedding_side_dim),  # NCHW grid
            fl.ConvTranspose2d(
                in_channels=embedding_dim, out_channels=embedding_dim // 4, kernel_size=2, stride=2, device=device, dtype=dtype
            ),
            fl.LayerNorm2d(channels=embedding_dim // 4, device=device, dtype=dtype),
            fl.GeLU(),
            fl.ConvTranspose2d(
                in_channels=embedding_dim // 4, out_channels=embedding_dim // 8, kernel_size=2, stride=2, device=device, dtype=dtype
            ),
            fl.GeLU(),
            fl.Reshape(embedding_dim // 8, -1),  # (B, C/8, 4H·4W) for the hypernetwork matmul
            fl.SetContext(context="mask_decoder", key="upscaled_dense_embedding"),
        )


class MaskDecoderTokens(fl.Chain):
    def __init__(
        self, embedding_dim: int = 256, num_mask_tokens: int = 4, device: Any = None, dtype: Any = None
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_mask_tokens = num_mask_tokens
        # output tokens (single + multi-mask) + IoU token
        super().__init__(
            fl.UseContext(context="mask_decoder", key="image_embedding"),  # for the batch size
            fl.Parameter(num_mask_tokens + 1, embedding_dim, device=device, dtype=dtype),
        )


class MaskPrediction(fl.Chain):
    def __init__(
        self,
        embedding_dim: int,
        num_mask_tokens: int,
        multimask_output: bool,
        num_layers: int = 3,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_mask_tokens = num_mask_tokens
        self.num_layers = num_layers
        self.multimask_output = multimask_output
        start_mask, num_masks = (1, num_mask_tokens - 1) if multimask_output else (0, 1)
        super().__init__(
            fl.Slicing(dim=1, start=1, end=num_mask_tokens + 1),  # drop the IoU and prompt tokens
            fl.Matmul(
                input=Hypernetworks(
                    embedding_dim=embedding_dim,
                    num_layers=num_layers,
                    num_mask_tokens=num_mask_tokens,
                    device=device,
                    dtype=dtype,
                ),
                other=DenseEmbeddingUpscaling(embedding_dim=embedding_dim, device=device, dtype=dtype),
            ),
            fl.Slicing(dim=1, start=start_mask, end=start_mask + num_masks),
            fl.Reshape(num_masks, embedding_dim, embedding_dim),
        )


class IOUPrediction(fl.Chain):
    def __init__(
        self,
        embedding_dim: int,
        num_layers: int,
        num_mask_tokens: int,
        multimask_output: bool,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_layers = num_layers
        self.multimask_output = multimask_output
        super().__init__(
            fl.Slicing(dim=1, start=0, end=1),  # the IoU token
            fl.Squeeze(dim=1),
            fl.MultiLinear(
                input_dim=embedding_dim,
                output_dim=num_mask_tokens,
                inner_dim=embedding_dim,
                num_layers=num_layers,
                device=device,
                dtype=dtype,
            ),
            fl.Slicing(dim=-1, start=1) if multimask_output else fl.Slicing(dim=-1, start=0, end=1),
        )


class Predictions(fl.Parallel):
    def __init__(
        self,
        embedding_dim: int,
        num_mask_tokens: int,
        multimask_output: bool,
        num_layers: int = 3,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_mask_tokens = num_mask_tokens
        self.num_layers = num_layers
        super().__init__(
            MaskPrediction(
                embedding_dim=embedding_dim,
                num_mask_tokens=num_mask_tokens,
                multimask_output=multimask_output,
                device=device,
                dtype=dtype,
            ),
            IOUPrediction(
                embedding_dim=embedding_dim,
                num_layers=num_layers,
                num_mask_tokens=num_mask_tokens,
                multimask_output=multimask_output,
                device=device,
                dtype=dtype,
            ),
        )


class MaskDecoder(fl.Chain):
    def __init__(
        self,
        multimask_output: bool = True,
        embedding_dim: int = 256,
        feed_forward_dim: int = 2048,
        num_layers: int = 2,
        num_multimask_outputs: int = 3,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.multimask_output = multimask_output
        self.embedding_dim = embedding_dim
        self.feed_forward_dim = feed_forward_dim
        self.num_layers = num_layers
        self.num_multimask_outputs = num_multimask_outputs
        # +1 token for the single-output mask
        num_mask_tokens = self.num_multimask_outputs + 1
        super().__init__(
            MaskDecoderTokens(embedding_dim=embedding_dim, num_mask_tokens=num_mask_tokens, device=device, dtype=dtype),
            EmbeddingsAggregator(),
            Transformer(
                *(
                    TwoWayTransformerLayer(
                        embedding_dim=embedding_dim,
                        num_heads=8,
                        feed_forward_dim=feed_forward_dim,
                        use_residual_self_attention=i > 0,
                        device=device,
                        dtype=dtype,
                    )
                    for i in range(num_layers)
                ),
                SparseCrossDenseAttention(embedding_dim=embedding_dim, device=device, dtype=dtype),
                fl.LayerNorm(normalized_shape=embedding_dim, device=device, dtype=dtype),
            ),
            Predictions(
                embedding_dim=embedding_dim,
                num_mask_tokens=num_mask_tokens,
                multimask_output=multimask_output,
                device=device,
                dtype=dtype,
            ),
        )

    def init_context(self) -> Contexts:
        return {
            "mask_decoder": {
                "image_embedding": None,
                "point_embedding": None,
                "mask_embedding": None,
                "dense_positional_embedding": None,
            }
        }

    def set_image_embedding(self, image_embedding: torch.Tensor) -> None:
        self.use_context("mask_decoder")["image_embedding"] = image_embedding

    def set_point_embedding(self, point_embedding: torch.Tensor) -> None:
        self.use_context("mask_decoder")["point_embedding"] = point_embedding

    def set_mask_embedding(self, mask_embedding: torch.Tensor) -> None:
        self.use_context("mask_decoder")["mask_embedding"] = mask_embedding

    def set_dense_positional_embedding(self, dense_positional_embedding: torch.Tensor) -> None:
        self.use_context("mask_decoder")["dense_positional_embedding"] = dense_positional_embedding
