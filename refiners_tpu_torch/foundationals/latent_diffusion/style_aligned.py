"""StyleAligned (arXiv:2312.02133): shared self-attention across a batch;
counterpart of ``refiners_tpu/foundationals/latent_diffusion/style_aligned.py``.

The first sample of each CFG half is the reference. Every self-attention of
the UNet normalizes its queries and keys onto the reference's statistics
(AdaIN) and attends over its own keys and values followed by the
reference's: keys twice as long as the queries. At 64×64 latents the 64²
sites reach the flash kernel with Lq = 4096, Lk = 8192 and the 32² sites
with 1024 and 2048.
"""

from __future__ import annotations

from typing import Any, Generic, TypeVar

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")


class ExtractReferenceFeatures(fl.Module):
    """The first sample of each CFG half, each repeated over its half.

    Under a batch split over a mesh's "data" axis, `row_block` holds this
    rank's rows for the call (`parallel.inference.RowBlock`): a rank whose
    rows are one whole half holds its reference; any other gathers the
    batch (one all-gather) and keeps its rows of the result."""

    reads_other_rows = True
    row_block: Any = None

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        block = self.row_block
        if block is None:
            return self._references(features)
        if block.rows == block.total // 2:
            return features[:1].repeat_interleave(block.rows, dim=0)
        return self._references(block.gather(features)).narrow(0, block.start, block.rows)

    @staticmethod
    def _references(features: torch.Tensor) -> torch.Tensor:
        batch_size = features.shape[0] // 2
        features_cond, features_uncond = features.chunk(2)
        features_ref = torch.stack((features_cond[0], features_uncond[0]))
        return features_ref.repeat_interleave(batch_size, dim=0)


class AdaIN(fl.Module):
    """Adaptive instance normalization (arXiv:1703.06868) of the targets onto
    the reference's mean and standard deviation over the sequence."""

    def __init__(self, epsilon: float = 1e-8) -> None:
        super().__init__()
        self.epsilon = epsilon

    def forward(self, targets: torch.Tensor, reference: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        targets_mean = targets.mean(dim=-2, keepdim=True)
        targets_std = targets.std(dim=-2, keepdim=True, correction=1)
        targets_normalized = (targets - targets_mean) / (targets_std + self.epsilon)

        reference_mean = reference.mean(dim=-2, keepdim=True)
        reference_std = reference.std(dim=-2, keepdim=True, correction=1)
        return targets_normalized * reference_std + reference_mean, reference


class ScaleReferenceFeatures(fl.Module):
    """Scale every sample of each CFG half but its first. Under a batch
    split, `row_block` says which of this rank's rows those are (as
    `ExtractReferenceFeatures`)."""

    reads_other_rows = True
    row_block: Any = None

    def __init__(self, scale: float = 1.0) -> None:
        super().__init__()
        self.scale = scale

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        block = self.row_block
        if block is not None:
            half = block.total // 2
            return torch.cat([
                features[i : i + 1] if (block.start + i) % half == 0 else features[i : i + 1] * self.scale
                for i in range(block.rows)
            ])  # fmt: skip
        batch_size = features.shape[0] // 2
        stacked = features.reshape(2, batch_size, *features.shape[1:])
        stacked = torch.cat((stacked[:, :1], stacked[:, 1:] * self.scale), dim=1)
        return stacked.reshape(features.shape)


class StyleAligned(fl.Chain):
    """One of Q, K, V: AdaIN onto the reference, then (K and V) the scaled
    reference features concatenated along the sequence."""

    def __init__(self, adain: bool, concatenate: bool, scale: float = 1.0) -> None:
        super().__init__(
            fl.Parallel(fl.Identity(), ExtractReferenceFeatures()),
            AdaIN(),
            fl.Distribute(fl.Identity(), ScaleReferenceFeatures(scale=scale)),
            fl.Concatenate(fl.GetArg(index=0), fl.GetArg(index=1), dim=-2),
        )
        if not adain:
            self.remove(self.ensure_find(AdaIN))
        if not concatenate:
            self.replace(old_module=self.ensure_find(fl.Concatenate), new_module=fl.GetArg(index=0))

    @property
    def scale(self) -> float:
        return self.ensure_find(ScaleReferenceFeatures).scale

    @scale.setter
    def scale(self, scale: float) -> None:
        self.ensure_find(ScaleReferenceFeatures).scale = scale


class SharedSelfAttentionAdapter(fl.Chain, Adapter[fl.SelfAttention]):
    """Q, K and V each through a `StyleAligned` between the projections and
    the scaled dot-product attention. The three hold no weights; they are
    kept out of the adapter's registration (a list), as the JAX package
    keeps them out of its pytree."""

    def __init__(self, target: fl.SelfAttention, scale: float = 1.0) -> None:
        with self.setup_adapter(target):
            super().__init__(target)
        self._style_aligned_layers = [
            fl.Distribute(
                StyleAligned(adain=True, concatenate=False, scale=scale),  # query
                StyleAligned(adain=True, concatenate=True, scale=scale),  # key
                StyleAligned(adain=False, concatenate=True, scale=scale),  # value
            )
        ]

    @property
    def style_aligned_layers(self) -> fl.Distribute:
        return self._style_aligned_layers[0]

    def inject(self, parent: fl.Chain | None = None) -> "SharedSelfAttentionAdapter":
        self.target.insert_before_type(module_type=fl.ScaledDotProductAttention, new_module=self.style_aligned_layers)
        return super().inject(parent)

    def eject(self) -> None:
        self.target.remove(self.style_aligned_layers)
        super().eject()

    @property
    def scale(self) -> float:
        return self.style_aligned_layers.layer(0, StyleAligned).scale

    @scale.setter
    def scale(self, scale: float) -> None:
        for style_aligned_module in self.style_aligned_layers:
            style_aligned_module.scale = scale


class StyleAlignedAdapter(Generic[T], fl.Chain, Adapter[T]):
    """Every self-attention of the UNet turned into shared self-attention."""

    def __init__(self, target: T, scale: float = 1.0) -> None:
        with self.setup_adapter(target):
            super().__init__(target)
        # a tuple is not registered by torch: the adapters stay out of this one's children
        self.shared_self_attention_adapters = tuple(
            SharedSelfAttentionAdapter(target=self_attention, scale=scale)
            for self_attention in self.target.layers(fl.SelfAttention)
        )

    def inject(self, parent: fl.Chain | None = None) -> "StyleAlignedAdapter[T]":
        for adapter in self.shared_self_attention_adapters:
            adapter.inject()
        return super().inject(parent)

    def eject(self) -> None:
        for adapter in self.shared_self_attention_adapters:
            adapter.eject()
        super().eject()

    @property
    def scale(self) -> float:
        return self.shared_self_attention_adapters[0].scale

    @scale.setter
    def scale(self, scale: float) -> None:
        for adapter in self.shared_self_attention_adapters:
            adapter.scale = scale
