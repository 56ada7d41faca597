"""Self-attention guidance (SAG, arXiv:2210.00939); counterpart of
``refiners_tpu/foundationals/latent_diffusion/self_attention_guidance.py``.

The adapter records the middle block's self-attention map (softmax of
Q Kᵀ/√d, in float32: at 64×64 latents the middle block runs at 8×8, seq 64,
so it stays off the flash kernels) and its spatial shape. After the CFG
UNet call, the tokens that receive more than one unit of attention mass
mark where the predicted clean latents are blurred; a second UNet call on
the re-noised, partly blurred latents gives the guidance term. Latents are
NCHW.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Generic, TypeVar

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.utils import gaussian_blur, interpolate
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import Solver

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")


class SelfAttentionMap(fl.Passthrough):
    """Store softmax(Q Kᵀ/√d) of the (B, L, H·D) query and key, (B, H, L, L),
    in the "self_attention_map" context; the inputs go on unchanged."""

    def __init__(self, num_heads: int, context_key: str) -> None:
        self.num_heads = num_heads
        self.context_key = context_key
        super().__init__(
            fl.Lambda(func=self.compute_attention_scores),
            fl.SetContext(context="self_attention_map", key=context_key),
        )

    def split_to_multi_head(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 3, f"Expected (batch, seq, embedding), got {tuple(x.shape)}"
        assert x.shape[-1] % self.num_heads == 0
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, x.shape[-1] // self.num_heads).transpose(1, 2)

    def compute_attention_scores(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        q, k = self.split_to_multi_head(query), self.split_to_multi_head(key)
        attention = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
        return torch.softmax(attention, dim=-1).to(query.dtype)


class SelfAttentionShape(fl.Passthrough):
    """Append the (H, W) of the NCHW features to the "self_attention_map"
    context's list; the input goes on unchanged."""

    def __init__(self, context_key: str) -> None:
        self.context_key = context_key
        super().__init__(
            fl.SetContext(context="self_attention_map", key=context_key, callback=self.register_shape),
        )

    def register_shape(self, shapes: list[tuple[int, int]], x: torch.Tensor) -> None:
        assert x.ndim == 4, f"Expected 4D tensor, got {x.ndim}D with shape {tuple(x.shape)}"
        shapes.append(tuple(x.shape[2:4]))


class SAGAdapter(Generic[T], fl.Chain, Adapter[T]):
    """Blur the predicted clean latents where the middle block's attention
    mass concentrates; the UNet-specific subclasses place the recorders."""

    def __init__(self, target: T, scale: float = 1.0, kernel_size: int = 9, sigma: float = 1.0) -> None:
        self.scale = scale
        self.kernel_size = kernel_size
        self.sigma = sigma
        with self.setup_adapter(target):
            super().__init__(target)

    def compute_sag_mask(self, latents: torch.Tensor, classifier_free_guidance: bool = True) -> torch.Tensor:
        """The (B, C, H, W) mask of the tokens whose attention mass, averaged
        over heads and summed over queries, exceeds 1 (the unconditional half
        of a CFG batch), resized to the latents by nearest neighbour.

        The recorders write into the target's context, which is read here.
        It is this adapter's own only until the target is ejected from a
        first SAG adapter: a detached target keeps that adapter's context
        dict and updates it in place when the next adapter wraps it."""
        context = self.target.use_context("self_attention_map")
        attn_map = context["middle_block_attn_map"]
        if classifier_free_guidance:
            attn_map = attn_map.chunk(2)[0]
        attn_shape = context["middle_block_attn_shape"].pop()
        assert len(attn_shape) == 2
        b, c, h, w = latents.shape
        attn_h, attn_w = attn_shape
        attn_mask = attn_map.mean(dim=1).sum(dim=1) > 1.0
        attn_mask = attn_mask.reshape(b, 1, attn_h, attn_w).to(attn_map.dtype).expand(b, c, attn_h, attn_w)
        return interpolate(attn_mask, (h, w))

    def compute_degraded_latents(
        self,
        solver: Solver,
        latents: torch.Tensor,
        noise: torch.Tensor,
        step: int,
        classifier_free_guidance: bool = True,
    ) -> torch.Tensor:
        sag_mask = self.compute_sag_mask(latents=latents, classifier_free_guidance=classifier_free_guidance)
        original_latents = solver.remove_noise(x=latents, noise=noise, step=step)
        degraded_latents = gaussian_blur(original_latents, kernel_size=self.kernel_size, sigma=self.sigma)
        degraded_latents = degraded_latents * sag_mask + original_latents * (1 - sag_mask)
        return solver.add_noise(degraded_latents, noise=noise, step=step)

    def init_context(self) -> Contexts:
        return {"self_attention_map": {"middle_block_attn_map": None, "middle_block_attn_shape": []}}

