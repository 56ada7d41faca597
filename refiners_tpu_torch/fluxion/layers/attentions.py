"""Attention layers; counterpart of ``refiners_tpu/fluxion/layers/attentions.py``.

`ScaledDotProductAttention` routes to the hand-written flash kernels
(``ops.flash_attention.flash_attention_packed``) under the JAX layer's
conditions: never when ``is_optimized`` is False, always when ``slice_size``
is set, and otherwise when the tensors are on the card and both sequences are
at least ``FLASH_MIN_SEQ`` long, in bfloat16, float16 or float32. Everything
else takes the plain math path. Under autograd the kernel route runs the
backward kernels.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion.layers.basics import Identity
from refiners_tpu_torch.fluxion.layers.chain import Chain, Distribute, Parallel
from refiners_tpu_torch.fluxion.layers.linear import Linear
from refiners_tpu_torch.fluxion.layers.module import Module
from refiners_tpu_torch.ops.attention import dot_product_attention, flash_auto, merge_heads, split_heads
from refiners_tpu_torch.ops.flash_attention import flash_attention_packed


class ScaledDotProductAttention(Module):
    """Multi-head attention over (B, L, H·D) inputs."""

    def __init__(
        self,
        num_heads: int = 1,
        is_causal: bool = False,
        is_optimized: bool = True,
        slice_size: int | None = None,
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.is_causal = is_causal
        self.is_optimized = is_optimized
        self.slice_size = slice_size

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        use_flash = self.is_optimized and (
            self.slice_size is not None or flash_auto(query, query.shape[1], key.shape[1])
        )
        if use_flash:
            return flash_attention_packed(
                query, key, value, is_causal=self.is_causal, head_dim=query.shape[-1] // self.num_heads
            )
        out = dot_product_attention(
            split_heads(query, self.num_heads),
            split_heads(key, self.num_heads),
            split_heads(value, self.num_heads),
            is_causal=self.is_causal,
            use_flash=False,
        )
        return merge_heads(out)


class Attention(Chain):
    """Q/K/V projections → multi-head attention → output projection."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int = 1,
        key_embedding_dim: int | None = None,
        value_embedding_dim: int | None = None,
        inner_dim: int | None = None,
        use_bias: bool = True,
        is_causal: bool = False,
        is_optimized: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        assert embedding_dim % num_heads == 0, f"embedding_dim {embedding_dim} must be divisible by num_heads {num_heads}"
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        self.heads_dim = embedding_dim // num_heads
        self.key_embedding_dim = key_embedding_dim or embedding_dim
        self.value_embedding_dim = value_embedding_dim or embedding_dim
        self.inner_dim = inner_dim or embedding_dim
        self.use_bias = use_bias
        self.is_causal = is_causal
        self.is_optimized = is_optimized
        super().__init__(
            Distribute(
                Linear(self.embedding_dim, self.inner_dim, bias=use_bias, device=device, dtype=dtype),
                Linear(self.key_embedding_dim, self.inner_dim, bias=use_bias, device=device, dtype=dtype),
                Linear(self.value_embedding_dim, self.inner_dim, bias=use_bias, device=device, dtype=dtype),
            ),
            ScaledDotProductAttention(num_heads=num_heads, is_causal=is_causal, is_optimized=is_optimized),
            Linear(self.inner_dim, self.embedding_dim, bias=True, device=device, dtype=dtype),
        )


class SelfAttention(Attention):
    """Attention with Q = K = V = x."""

    def __init__(
        self,
        embedding_dim: int,
        inner_dim: int | None = None,
        num_heads: int = 1,
        use_bias: bool = True,
        is_causal: bool = False,
        is_optimized: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            embedding_dim=embedding_dim,
            inner_dim=inner_dim,
            num_heads=num_heads,
            use_bias=use_bias,
            is_causal=is_causal,
            is_optimized=is_optimized,
            device=device,
            dtype=dtype,
        )
        self.insert(0, Parallel(Identity(), Identity(), Identity()))


class SelfAttention2d(SelfAttention):
    """Self-attention over NCHW feature maps: (B, C, H, W) ↔ (B, H·W, C)
    around the attention chain; the spatial shape is recorded in the
    "reshape" context for adapters that read it."""

    def __init__(
        self,
        channels: int,
        num_heads: int = 1,
        use_bias: bool = True,
        is_causal: bool = False,
        is_optimized: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        assert channels % num_heads == 0, f"channels {channels} must be divisible by num_heads {num_heads}"
        self.channels = channels
        super().__init__(
            embedding_dim=channels,
            num_heads=num_heads,
            use_bias=use_bias,
            is_causal=is_causal,
            is_optimized=is_optimized,
            device=device,
            dtype=dtype,
        )

    def init_context(self) -> dict[str, dict[str, Any]]:
        return {"reshape": {"height": None, "width": None}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        ctx = self.use_context("reshape")
        ctx["height"], ctx["width"] = h, w
        seq = x.reshape(b, c, h * w).transpose(1, 2)
        out = super().forward(seq)
        return out.transpose(1, 2).reshape(b, c, h, w)
