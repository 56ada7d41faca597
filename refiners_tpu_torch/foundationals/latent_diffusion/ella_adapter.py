"""ELLA (arXiv:2403.05135): an LLM's text embedding resampled, at each
timestep, into the latents that the UNet's cross-attentions read in place of
CLIP's; counterpart of
``refiners_tpu/foundationals/latent_diffusion/ella_adapter.py``.

`ELLAAdapter.inject` puts the `ELLA` encoder first in the UNet and points
every cross-attention's text `UseContext` at ("ella", "latents"). The
per-cross-attention adapters and the encoder are kept out of the adapter's
registration (lists), as the JAX package keeps them out of its pytree, so
that the UNet's `state_dict()` keys are the JAX package's. This
`PerceiverResampler` is ELLA's, not the IP-Adapter's of `image_prompt.py`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Generic, TypeVar

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeEncoder

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")
TELLAAdapter = TypeVar("TELLAAdapter", bound="ELLAAdapter[Any]")


class LayerNormNoAffine(fl.Module):
    """LayerNorm over the last dim, in float32, without weight or bias."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x.float(), dim=-1, keepdim=True, correction=0)
        return ((x.float() - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class TimestepEncoder(fl.Passthrough):
    """The diffusion timestep's embedding, set as ("ella", "timestep_embedding")."""

    def __init__(self, time_embedding_dim: int, time_channel: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.UseContext("diffusion", "timestep"),
            RangeEncoder(time_channel, time_embedding_dim, device=device, dtype=dtype),
            fl.SetContext("ella", "timestep_embedding"),
        )


class SquaredReLU(fl.ReLU):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) ** 2


class AdaLayerNorm(fl.Chain):
    """LayerNorm modulated by the timestep embedding: x·(1 + scale) + shift,
    both from one Linear, zero at initialization."""

    def __init__(self, embedding_dim: int, time_embedding_dim: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.Parallel(
                LayerNormNoAffine(embedding_dim, eps=1e-6, device=device, dtype=dtype),
                fl.Chain(
                    fl.UseContext("ella", "timestep_embedding"),
                    fl.SiLU(),
                    fl.Linear(time_embedding_dim, embedding_dim * 2, device=device, dtype=dtype),
                ),
            ),
            fl.Lambda(self._scale_shift_tensors),
        )
        linear = self.ensure_find(fl.Linear)
        with torch.no_grad():
            linear.weight.zero_()
            linear.bias.zero_()

    def _scale_shift_tensors(self, x: torch.Tensor, time_embedding: torch.Tensor) -> torch.Tensor:
        shift, scale = time_embedding.chunk(2, dim=-1)
        return x * (1 + scale) + shift


class ParameterInitialized(fl.Parameter):
    """A parameter drawn from N(0, dims[1]), as the JAX package draws it."""

    def __init__(self, *dims: int, requires_grad: bool = True, device: Any = None, dtype: Any = None) -> None:
        super().__init__(*dims, requires_grad=requires_grad, device=device, dtype=dtype)
        self.weight = rng.init_normal(dims, std=dims[1] ** 0.5, device=device, dtype=dtype)
        self.weight.requires_grad_(requires_grad)


class Latents(fl.Chain):
    def __init__(self, num_latents: int, width: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(ParameterInitialized(num_latents, width, device=device, dtype=dtype))


class PerceiverAttention(fl.Chain):
    """The latents attend to themselves and the text: queries from the
    latents, keys and values from (latents ‖ text), both modulated first."""

    def __init__(
        self, width: int, num_heads: int, timestep_embedding_dim: int, device: Any = None, dtype: Any = None
    ) -> None:
        super().__init__(
            fl.Distribute(
                AdaLayerNorm(width, timestep_embedding_dim, device=device, dtype=dtype),
                AdaLayerNorm(width, timestep_embedding_dim, device=device, dtype=dtype),
            ),
            fl.Parallel(
                fl.GetArg(index=1),
                fl.Lambda(func=self.to_kv),
                fl.Lambda(func=self.to_kv),
            ),
            fl.Attention(embedding_dim=width, num_heads=num_heads, device=device, dtype=dtype),
        )

    def to_kv(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        return torch.cat((latents, x), dim=-2)


class OutputProjection(fl.Chain):
    def __init__(self, width: int, output_dim: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.Linear(width, output_dim, device=device, dtype=dtype),
            fl.LayerNorm(output_dim, device=device, dtype=dtype),
        )


class Transformer(fl.Chain):
    pass


class TransformerLayer(fl.Chain):
    pass


class FeedForward(fl.Chain):
    def __init__(self, width: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.Linear(width, width * 4, device=device, dtype=dtype),
            SquaredReLU(),
            fl.Linear(width * 4, width, device=device, dtype=dtype),
        )


class PerceiverResampler(fl.Chain):
    """The text projected to `width`, then `num_latents` learned latents
    (plus the timestep embedding) refined by `num_layers` perceiver layers."""

    def __init__(
        self,
        time_embedding_dim: int,
        width: int,
        num_layers: int,
        num_heads: int,
        num_latents: int,
        output_dim: int | None,
        input_dim: int | None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            fl.Linear(input_dim, width, device=device, dtype=dtype) if input_dim else fl.Identity(),
            fl.SetContext("perceiver_resampler", "x"),
            Latents(num_latents, width, device=device, dtype=dtype),
            fl.Residual(
                fl.UseContext("ella", "timestep_embedding"),
                fl.SiLU(),
                fl.Linear(time_embedding_dim, width, device=device, dtype=dtype),
            ),
            Transformer(
                TransformerLayer(
                    fl.Residual(
                        fl.Parallel(fl.UseContext(context="perceiver_resampler", key="x"), fl.Identity()),
                        PerceiverAttention(width, num_heads, time_embedding_dim, device=device, dtype=dtype),
                    ),
                    fl.Residual(
                        AdaLayerNorm(width, time_embedding_dim, device=device, dtype=dtype),
                        FeedForward(width, device=device, dtype=dtype),
                    ),
                )
                for _ in range(num_layers)
            ),
            OutputProjection(width, output_dim, device=device, dtype=dtype) if output_dim else fl.Identity(),
        )

    def init_context(self) -> Contexts:
        return {"perceiver_resampler": {"x": None}}


class ELLA(fl.Passthrough):
    """The ELLA latents encoder: reads the LLM text embedding from
    ("adapted_cross_attention_block", "llm_text_embedding") and sets
    ("ella", "latents")."""

    def __init__(
        self,
        time_channel: int,
        timestep_embedding_dim: int,
        width: int,
        num_layers: int,
        num_heads: int,
        num_latents: int,
        input_dim: int | None = None,
        out_dim: int | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            TimestepEncoder(timestep_embedding_dim, time_channel, device=device, dtype=dtype),
            fl.UseContext("adapted_cross_attention_block", "llm_text_embedding"),
            PerceiverResampler(
                timestep_embedding_dim,
                width,
                num_layers,
                num_heads,
                num_latents,
                out_dim,
                input_dim,
                device=device,
                dtype=dtype,
            ),
            fl.SetContext("ella", "latents"),
        )


class ELLACrossAttentionAdapter(fl.Chain, Adapter[fl.UseContext]):
    """A cross-attention's text `UseContext` swapped for the ELLA latents."""

    def __init__(self, target: fl.UseContext) -> None:
        with self.setup_adapter(target):
            super().__init__(fl.UseContext("ella", "latents"))


class ELLAAdapter(Generic[T], fl.Chain, Adapter[T]):
    def __init__(self, target: T, latents_encoder: ELLA, weights: dict[str, torch.Tensor] | None = None) -> None:
        if weights is not None:
            latents_encoder.load_state_dict(weights)
        # lists keep torch from registering these here: `inject` puts the encoder in the UNet
        self._latents_encoder = [latents_encoder]
        with self.setup_adapter(target):
            super().__init__(target)
        self.sub_adapters = [
            ELLACrossAttentionAdapter(use_context)
            for cross_attn in target.layers(CrossAttentionBlock)
            for use_context in cross_attn.layers(fl.UseContext)
        ]

    def inject(self: TELLAAdapter, parent: fl.Chain | None = None) -> TELLAAdapter:
        for adapter in self.sub_adapters:
            adapter.inject()
        self.target.insert(0, self.latents_encoder)
        return super().inject(parent)

    def eject(self) -> None:
        for adapter in self.sub_adapters:
            adapter.eject()
        self.target.pop(0)
        super().eject()

    @property
    def latents_encoder(self) -> ELLA:
        return self._latents_encoder[0]

    def set_llm_text_embedding(self, text_embedding: torch.Tensor) -> None:
        """The CFG-stacked LLM embedding (negative first), cast to the
        encoder's device and dtype."""
        encoder = self.latents_encoder
        text_embedding = text_embedding.to(device=encoder.device, dtype=encoder.dtype)
        self.set_context("adapted_cross_attention_block", {"llm_text_embedding": text_embedding})

    def init_context(self) -> Contexts:
        return {"ella": {"timestep_embedding": None, "latents": None}}
