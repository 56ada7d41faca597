"""IP-Adapter (arXiv:2308.06721): image-prompt conditioning; counterpart of
``refiners_tpu/foundationals/latent_diffusion/image_prompt.py``.

A CLIP image encoder embeds the image prompt; `ImageProjection` (pooled
embedding → 4 tokens) or `PerceiverResampler` (the penultimate layer's grid
features → 16 tokens, "plus") makes text-width tokens of it. Each text
cross-attention of the UNet then adds an image cross-attention that shares
its query and attends to those tokens with keys and values of its own. With
4 or 16 keys it takes the plain attention path. Images are NCHW.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any, Generic, TypeVar

import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.utils import image_to_tensor, normalize
from refiners_tpu_torch.foundationals.clip.image_encoder import CLIPImageEncoderH

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")
TIPAdapter = TypeVar("TIPAdapter", bound="IPAdapter[Any]")


class ImageProjection(fl.Chain):
    """A pooled CLIP image embedding → `num_tokens` tokens of text width."""

    def __init__(
        self,
        clip_image_embedding_dim: int = 1024,
        clip_text_embedding_dim: int = 768,
        num_tokens: int = 4,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.clip_image_embedding_dim = clip_image_embedding_dim
        self.clip_text_embedding_dim = clip_text_embedding_dim
        self.num_tokens = num_tokens
        super().__init__(
            fl.Linear(
                in_features=clip_image_embedding_dim,
                out_features=clip_text_embedding_dim * num_tokens,
                device=device,
                dtype=dtype,
            ),
            fl.Reshape(num_tokens, clip_text_embedding_dim),
            fl.LayerNorm(normalized_shape=clip_text_embedding_dim, device=device, dtype=dtype),
        )


class FeedForward(fl.Chain):
    def __init__(self, embedding_dim: int, feedforward_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.embedding_dim = embedding_dim
        self.feedforward_dim = feedforward_dim
        super().__init__(
            fl.Linear(in_features=embedding_dim, out_features=feedforward_dim, bias=False, device=device, dtype=dtype),
            fl.GeLU(),
            fl.Linear(in_features=feedforward_dim, out_features=embedding_dim, bias=False, device=device, dtype=dtype),
        )


class PerceiverScaledDotProductAttention(fl.Module):
    """Attention of the latents over (input ‖ latents). Q and K are each
    scaled by d^-¼ before their product, which is taken in float32."""

    def __init__(self, head_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.scale = 1 / math.sqrt(math.sqrt(head_dim))

    def forward(self, key_value: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
        bs, length, _ = query.shape
        key, value = key_value.chunk(2, dim=-1)
        q = self.reshape_tensor(query)
        k = self.reshape_tensor(key)
        v = self.reshape_tensor(value)
        logits = torch.einsum("bhqd,bhkd->bhqk", (q * self.scale).float(), (k * self.scale).float())
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
        return out.transpose(1, 2).reshape(bs, length, -1)

    def reshape_tensor(self, x: torch.Tensor) -> torch.Tensor:
        bs, length, _ = x.shape
        return x.reshape(bs, length, self.num_heads, -1).transpose(1, 2)


class PerceiverAttention(fl.Chain):
    def __init__(
        self, embedding_dim: int, head_dim: int = 64, num_heads: int = 8, device: Any = None, dtype: Any = None
    ) -> None:
        self.embedding_dim = embedding_dim
        self.head_dim = head_dim
        self.inner_dim = head_dim * num_heads
        super().__init__(
            fl.Distribute(
                fl.LayerNorm(normalized_shape=embedding_dim, device=device, dtype=dtype),
                fl.LayerNorm(normalized_shape=embedding_dim, device=device, dtype=dtype),
            ),
            fl.Parallel(
                fl.Chain(
                    fl.Lambda(func=self.to_kv),
                    fl.Linear(
                        in_features=embedding_dim,
                        out_features=2 * self.inner_dim,
                        bias=False,
                        device=device,
                        dtype=dtype,
                    ),  # Wkv
                ),
                fl.Chain(
                    fl.GetArg(index=1),
                    fl.Linear(
                        in_features=embedding_dim, out_features=self.inner_dim, bias=False, device=device, dtype=dtype
                    ),  # Wq
                ),
            ),
            PerceiverScaledDotProductAttention(head_dim=head_dim, num_heads=num_heads),
            fl.Linear(in_features=self.inner_dim, out_features=embedding_dim, bias=False, device=device, dtype=dtype),
        )

    def to_kv(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        return torch.cat((x, latents), dim=-2)


class LatentsToken(fl.Chain):
    def __init__(self, num_tokens: int, latents_dim: int, device: Any = None, dtype: Any = None) -> None:
        self.num_tokens = num_tokens
        self.latents_dim = latents_dim
        super().__init__(fl.Parameter(num_tokens, latents_dim, device=device, dtype=dtype))


class Transformer(fl.Chain):
    pass


class TransformerLayer(fl.Chain):
    pass


class PerceiverResampler(fl.Chain):
    """Grid features → `num_tokens` learned latents refined by perceiver
    attention over the features, projected to `output_dim`."""

    def __init__(
        self,
        latents_dim: int = 1024,
        num_attention_layers: int = 8,
        num_attention_heads: int = 16,
        head_dim: int = 64,
        num_tokens: int = 8,
        input_dim: int = 768,
        output_dim: int = 1024,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.latents_dim = latents_dim
        self.num_attention_layers = num_attention_layers
        self.head_dim = head_dim
        self.num_attention_heads = num_attention_heads
        self.num_tokens = num_tokens
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.feedforward_dim = 4 * latents_dim
        super().__init__(
            fl.Linear(in_features=input_dim, out_features=latents_dim, device=device, dtype=dtype),
            fl.SetContext(context="perceiver_resampler", key="x"),
            LatentsToken(num_tokens, latents_dim, device=device, dtype=dtype),
            Transformer(
                TransformerLayer(
                    fl.Residual(
                        fl.Parallel(fl.UseContext(context="perceiver_resampler", key="x"), fl.Identity()),
                        PerceiverAttention(
                            embedding_dim=latents_dim,
                            head_dim=head_dim,
                            num_heads=num_attention_heads,
                            device=device,
                            dtype=dtype,
                        ),
                    ),
                    fl.Residual(
                        fl.LayerNorm(normalized_shape=latents_dim, device=device, dtype=dtype),
                        FeedForward(
                            embedding_dim=latents_dim, feedforward_dim=self.feedforward_dim, device=device, dtype=dtype
                        ),
                    ),
                )
                for _ in range(num_attention_layers)
            ),
            fl.Linear(in_features=latents_dim, out_features=output_dim, device=device, dtype=dtype),
            fl.LayerNorm(normalized_shape=output_dim, device=device, dtype=dtype),
        )

    def init_context(self) -> Contexts:
        return {"perceiver_resampler": {"x": None}}


class ImageCrossAttention(fl.Chain):
    """The text cross-attention's query against keys and values projected
    from the "ip_adapter"/"clip_image_embedding" tokens, scaled; on the text
    cross-attention's device and dtype."""

    def __init__(self, text_cross_attention: fl.Attention, scale: float = 1.0) -> None:
        device, dtype = text_cross_attention.device, text_cross_attention.dtype
        self._multiply = [fl.Multiply(scale)]
        super().__init__(
            fl.Distribute(
                fl.Identity(),
                fl.Chain(
                    fl.UseContext(context="ip_adapter", key="clip_image_embedding"),
                    fl.Linear(
                        in_features=text_cross_attention.key_embedding_dim,
                        out_features=text_cross_attention.inner_dim,
                        bias=text_cross_attention.use_bias,
                        device=device,
                        dtype=dtype,
                    ),
                ),
                fl.Chain(
                    fl.UseContext(context="ip_adapter", key="clip_image_embedding"),
                    fl.Linear(
                        in_features=text_cross_attention.value_embedding_dim,
                        out_features=text_cross_attention.inner_dim,
                        bias=text_cross_attention.use_bias,
                        device=device,
                        dtype=dtype,
                    ),
                ),
            ),
            fl.ScaledDotProductAttention(
                num_heads=text_cross_attention.num_heads, is_causal=text_cross_attention.is_causal
            ),
            self.multiply,
        )

    @property
    def multiply(self) -> fl.Multiply:
        return self._multiply[0]

    @property
    def scale(self) -> float:
        return self.multiply.scale

    @scale.setter
    def scale(self, value: float) -> None:
        self.multiply.scale = value


class CrossAttentionAdapter(fl.Chain, Adapter[fl.Attention]):
    """Replaces the text cross-attention's scaled dot-product attention by
    its sum with an `ImageCrossAttention`."""

    def __init__(self, target: fl.Attention, scale: float = 1.0) -> None:
        with self.setup_adapter(target):
            super().__init__(target)
        self._image_cross_attention = [ImageCrossAttention(text_cross_attention=target, scale=scale)]

    def inject(self, parent: fl.Chain | None = None) -> "CrossAttentionAdapter":
        sdpa = self.target.ensure_find(fl.ScaledDotProductAttention)
        self.target.replace(old_module=sdpa, new_module=fl.Sum(sdpa, self.image_cross_attention))
        return super().inject(parent)

    def eject(self) -> None:
        parent = self.target.ensure_find_parent(self.image_cross_attention)
        parent.remove(self.image_cross_attention)
        sdpa = parent.layer("ScaledDotProductAttention", fl.ScaledDotProductAttention)
        self.target.replace(old_module=parent, new_module=sdpa)
        super().eject()

    @property
    def image_cross_attention(self) -> ImageCrossAttention:
        return self._image_cross_attention[0]

    @property
    def image_key_projection(self) -> fl.Linear:
        return self.image_cross_attention.layer(("Distribute", 1, "Linear"), fl.Linear)

    @property
    def image_value_projection(self) -> fl.Linear:
        return self.image_cross_attention.layer(("Distribute", 2, "Linear"), fl.Linear)

    @property
    def scale(self) -> float:
        return self.image_cross_attention.scale

    @scale.setter
    def scale(self, value: float) -> None:
        self.image_cross_attention.scale = value

    def load_weights(self, key_tensor: torch.Tensor, value_tensor: torch.Tensor) -> None:
        """The key and value projections' weights from a checkpoint, in the
        torch (out, in) layout, which is the port's: copied unchanged."""
        with torch.no_grad():
            self.image_key_projection.weight.copy_(key_tensor)
            self.image_value_projection.weight.copy_(value_tensor)


class IPAdapter(Generic[T], fl.Chain, Adapter[T]):
    """Image-prompt adapter for SD UNets. The image encoder, the projection
    and the per-cross-attention adapters are kept out of the adapter's
    registration (lists), as the JAX package keeps them out of its pytree:
    the adapter's `state_dict()` is its target's."""

    def __init__(
        self,
        target: T,
        clip_image_encoder: CLIPImageEncoderH,
        image_proj: fl.Module,
        scale: float = 1.0,
        fine_grained: bool = False,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        with self.setup_adapter(target):
            super().__init__(target)

        self.fine_grained = fine_grained
        self._clip_image_encoder = [clip_image_encoder]
        if fine_grained:
            self._grid_image_encoder = [self.convert_to_grid_features(clip_image_encoder)]
        self._image_proj = [image_proj]

        self.sub_adapters = [
            CrossAttentionAdapter(target=cross_attn, scale=scale)
            for cross_attn in filter(lambda attn: type(attn) != fl.SelfAttention, target.layers(fl.Attention))
        ]

        if weights is not None:
            image_proj_state_dict = {
                k.removeprefix("image_proj."): v for k, v in weights.items() if k.startswith("image_proj.")
            }
            self.image_proj.load_state_dict(image_proj_state_dict)
            for i, cross_attn in enumerate(self.sub_adapters):
                prefix = f"ip_adapter.{i:03d}."
                cross_attention_weights = [v for k, v in weights.items() if k.startswith(prefix)]
                assert len(cross_attention_weights) == 2
                cross_attn.load_weights(*cross_attention_weights)

    @property
    def clip_image_encoder(self) -> CLIPImageEncoderH:
        return self._clip_image_encoder[0]

    @property
    def grid_image_encoder(self) -> CLIPImageEncoderH:
        assert hasattr(self, "_grid_image_encoder")
        return self._grid_image_encoder[0]

    @property
    def image_proj(self) -> fl.Module:
        return self._image_proj[0]

    def inject(self: "TIPAdapter", parent: fl.Chain | None = None) -> "TIPAdapter":
        for adapter in self.sub_adapters:
            adapter.inject()
        return super().inject(parent)

    def eject(self) -> None:
        for adapter in self.sub_adapters:
            adapter.eject()
        super().eject()

    @property
    def scale(self) -> float:
        return self.sub_adapters[0].scale

    @scale.setter
    def scale(self, value: float) -> None:
        for cross_attn in self.sub_adapters:
            cross_attn.scale = value

    def set_clip_image_embedding(self, image_embedding: torch.Tensor) -> None:
        """The CFG-stacked image tokens, cast to the target's device and
        dtype (a float32 embedding would otherwise promote a bf16 UNet)."""
        image_embedding = image_embedding.to(device=self.target.device, dtype=self.target.dtype)
        self.set_context("ip_adapter", {"clip_image_embedding": image_embedding})

    def compute_clip_image_embedding(
        self,
        image_prompt: Image.Image | list[Image.Image] | torch.Tensor,
        weights: list[float] | None = None,
        concat_batches: bool = True,
    ) -> torch.Tensor:
        """The (negative ‖ conditional) image tokens on the target's device
        and dtype; optional per-image weights; several images concatenated
        into one longer token sequence."""
        if isinstance(image_prompt, Image.Image):
            image_prompt = self.preprocess_image(image_prompt)
        elif isinstance(image_prompt, list):
            assert all(isinstance(image, Image.Image) for image in image_prompt)
            image_prompt = torch.cat([self.preprocess_image(image) for image in image_prompt])

        negative_embedding, conditional_embedding = self._compute_clip_image_embedding(image_prompt)

        batch_size = image_prompt.shape[0]
        if weights is not None:
            assert len(weights) == batch_size, f"Got {len(weights)} weights for {batch_size} images"
            if any(weight != 1.0 for weight in weights):
                w = torch.tensor(weights, device=conditional_embedding.device, dtype=conditional_embedding.dtype)
                conditional_embedding = conditional_embedding * w[:, None, None]

        if batch_size > 1 and concat_batches:
            # a longer image-token sequence for several images
            negative_embedding = torch.cat(negative_embedding.chunk(batch_size), dim=1)
            conditional_embedding = torch.cat(conditional_embedding.chunk(batch_size), dim=1)

        embedding = torch.cat((negative_embedding, conditional_embedding))
        return embedding.to(device=self.target.device, dtype=self.target.dtype)

    def _compute_clip_image_embedding(self, image_prompt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        image_encoder = self.clip_image_encoder if not self.fine_grained else self.grid_image_encoder
        image_prompt = image_prompt.to(device=image_encoder.device, dtype=image_encoder.dtype)
        clip_embedding = image_encoder(image_prompt)
        conditional_embedding = self.image_proj(clip_embedding)
        if not self.fine_grained:
            negative_embedding = self.image_proj(torch.zeros_like(clip_embedding))
        else:
            clip_embedding = image_encoder(torch.zeros_like(image_prompt))
            negative_embedding = self.image_proj(clip_embedding)
        return negative_embedding, conditional_embedding

    def preprocess_image(
        self,
        image: Image.Image,
        size: tuple[int, int] = (224, 224),
        mean: list[float] | None = None,
        std: list[float] | None = None,
    ) -> torch.Tensor:
        """Resize, then CLIP's normalization: (1, 3, H, W) on the target's device and dtype."""
        resized = image.resize(size)
        return normalize(
            image_to_tensor(resized, device=self.target.device, dtype=self.target.dtype),
            mean=[0.48145466, 0.4578275, 0.40821073] if mean is None else mean,
            std=[0.26862954, 0.26130258, 0.27577711] if std is None else std,
        )

    @staticmethod
    def convert_to_grid_features(clip_image_encoder: CLIPImageEncoderH) -> CLIPImageEncoderH:
        """The penultimate layer's grid features: a structural copy (the same
        weights) without the pooling, the final norm and projection, and the
        last transformer layer."""
        encoder_clone = clip_image_encoder.structural_copy()
        assert isinstance(encoder_clone[-1], fl.Linear)  # final proj
        assert isinstance(encoder_clone[-2], fl.LayerNorm)  # final normalization
        assert isinstance(encoder_clone[-3], fl.Lambda)  # pooling (classif token)
        for _ in range(3):
            encoder_clone.pop()
        transformer_layers = encoder_clone[-1]
        assert isinstance(transformer_layers, fl.Chain) and len(transformer_layers) >= 2
        transformer_layers.pop()
        return encoder_clone
