"""CLIP text encoders (L / H / G); counterpart of
``refiners_tpu/foundationals/clip/text_encoder.py``. Same declarative
structure, so the tree paths and weight keys are the JAX package's."""

from __future__ import annotations

from typing import Any

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.clip.common import FeedForward, PositionalEncoder
from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer


class TokenEncoder(fl.Embedding):
    def __init__(self, vocabulary_size: int, embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.vocabulary_size = vocabulary_size
        super().__init__(num_embeddings=vocabulary_size, embedding_dim=embedding_dim, device=device, dtype=dtype)


class TransformerLayer(fl.Chain):
    """Pre-norm causal self-attention + GeLU feed-forward block."""

    def __init__(
        self,
        embedding_dim: int,
        feedforward_dim: int,
        num_attention_heads: int = 1,
        layer_norm_eps: float = 1e-5,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.num_attention_heads = num_attention_heads
        self.feedforward_dim = feedforward_dim
        self.layer_norm_eps = layer_norm_eps
        super().__init__(
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=layer_norm_eps, device=device, dtype=dtype),
                fl.SelfAttention(
                    embedding_dim=embedding_dim, num_heads=num_attention_heads, is_causal=True, device=device, dtype=dtype
                ),
            ),
            fl.Residual(
                fl.LayerNorm(normalized_shape=embedding_dim, eps=layer_norm_eps, device=device, dtype=dtype),
                FeedForward(embedding_dim=embedding_dim, feedforward_dim=feedforward_dim, device=device, dtype=dtype),
            ),
        )


class CLIPTextEncoder(fl.Chain):
    """Tokenizer → embeddings → N causal transformer layers → LayerNorm."""

    def __init__(
        self,
        embedding_dim: int = 768,
        max_sequence_length: int = 77,
        vocabulary_size: int = 49408,
        num_layers: int = 12,
        num_attention_heads: int = 12,
        feedforward_dim: int = 3072,
        layer_norm_eps: float = 1e-5,
        use_quick_gelu: bool = False,
        tokenizer: CLIPTokenizer | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.max_sequence_length = max_sequence_length
        self.vocabulary_size = vocabulary_size
        self.num_layers = num_layers
        self.num_attention_heads = num_attention_heads
        self.feedforward_dim = feedforward_dim
        self.layer_norm_eps = layer_norm_eps
        self.use_quick_gelu = use_quick_gelu
        super().__init__(
            tokenizer or CLIPTokenizer(sequence_length=max_sequence_length),
            fl.Converter(set_dtype=False),
            fl.Sum(
                TokenEncoder(vocabulary_size=vocabulary_size, embedding_dim=embedding_dim, device=device, dtype=dtype),
                PositionalEncoder(
                    max_sequence_length=max_sequence_length, embedding_dim=embedding_dim, device=device, dtype=dtype
                ),
            ),
            *(
                TransformerLayer(
                    embedding_dim=embedding_dim,
                    num_attention_heads=num_attention_heads,
                    feedforward_dim=feedforward_dim,
                    layer_norm_eps=layer_norm_eps,
                    device=device,
                    dtype=dtype,
                )
                for _ in range(num_layers)
            ),
            fl.LayerNorm(normalized_shape=embedding_dim, eps=layer_norm_eps, device=device, dtype=dtype),
        )
        if use_quick_gelu:
            for gelu, parent in self.walk(predicate=lambda m, _: isinstance(m, fl.GeLU)):
                parent.replace(old_module=gelu, new_module=fl.GeLU(approximation=fl.GeLUApproximation.SIGMOID))


class CLIPTextEncoderL(CLIPTextEncoder):
    """CLIP-L: 768-dim, 12 layers, quick-GeLU."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            embedding_dim=768,
            num_layers=12,
            num_attention_heads=12,
            feedforward_dim=3072,
            use_quick_gelu=True,
            device=device,
            dtype=dtype,
        )


class CLIPTextEncoderH(CLIPTextEncoder):
    """CLIP-H: 1024-dim, 23 layers, plain GeLU. A facade: it builds on the
    card unless given a device."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            embedding_dim=1024,
            num_layers=23,
            num_attention_heads=16,
            feedforward_dim=4096,
            device=default_device(device),
            dtype=dtype,
        )


class CLIPTextEncoderG(CLIPTextEncoder):
    """CLIP-G: 1280-dim, 32 layers, pad token 0."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            embedding_dim=1280,
            num_layers=32,
            num_attention_heads=20,
            feedforward_dim=5120,
            tokenizer=CLIPTokenizer(pad_token_id=0),
            device=device,
            dtype=dtype,
        )
