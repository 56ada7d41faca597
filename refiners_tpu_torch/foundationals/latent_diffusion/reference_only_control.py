"""Reference-only control: the UNet's self-attention also attends to the
features of a guide image; counterpart of
``refiners_tpu/foundationals/latent_diffusion/reference_only_control.py``.

A guide UNet (a structural copy: the same weights) runs first on the noised
guide latents and saves the input of each self-attention. Each
self-attention of the UNet then runs twice: guided, its keys and values
extended by the guide's (keys twice as long as the queries: Lq = 4096,
Lk = 8192 at the 64² sites of 64×64 latents), and unguided on the
unconditional sample alone; the unconditional output mixes the two by
`style_cfg`. The CFG batch is assumed (batch 2), as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.layers import (
    Chain,
    Concatenate,
    Identity,
    Lambda,
    Parallel,
    Passthrough,
    SelfAttention,
    SetContext,
    UseContext,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet


class SaveLayerNormAdapter(Chain, Adapter[SelfAttention]):
    """Save the self-attention's input in `context` under "norm"."""

    def __init__(self, target: SelfAttention, context: str) -> None:
        self.context = context
        with self.setup_adapter(target):
            super().__init__(SetContext(self.context, "norm"), target)


def _first_sample(x: torch.Tensor) -> torch.Tensor:
    return x[:1]


class SelfAttentionInjectionAdapter(Chain, Adapter[SelfAttention]):
    """The guided self-attention (keys and values extended by the guide's
    saved input) beside the unguided one on the unconditional sample.

    Each row reads only its own row and the guide's, but the mix applies to
    the batch's first row alone: under a batch split over a mesh's "data"
    axis, `row_block` holds this rank's rows for the call
    (`parallel.inference.RowBlock`), and a rank without that row leaves its
    rows guided."""

    reads_other_rows = True
    row_block: Any = None

    def __init__(self, target: SelfAttention, context: str, style_cfg: float = 0.5) -> None:
        self.context = context
        self.style_cfg = style_cfg

        sa_guided = target.structural_copy()
        assert isinstance(sa_guided[0], Parallel)
        sa_guided.replace(
            sa_guided[0],
            Parallel(
                Identity(),
                Concatenate(Identity(), UseContext(self.context, "norm"), dim=1),
                Concatenate(Identity(), UseContext(self.context, "norm"), dim=1),
            ),
        )

        with self.setup_adapter(target):
            super().__init__(
                Parallel(sa_guided, Chain(Lambda(_first_sample), target)),
                Lambda(self.compute_averaged_unconditioned_x),
            )

    def compute_averaged_unconditioned_x(self, x: torch.Tensor, unguided_unconditioned_x: torch.Tensor) -> torch.Tensor:
        """`x` with its first (unconditional) sample mixed with the unguided
        one; a new tensor, the inputs stay as they are."""
        if self.row_block is not None and self.row_block.start > 0:
            return x
        first = self.style_cfg * x[:1] + (1.0 - self.style_cfg) * unguided_unconditioned_x[:1]
        return torch.cat((first, x[1:]), dim=0)


class SelfAttentionInjectionPassthrough(Passthrough):
    """Runs the guide UNet on the "reference_only_control"/"guide" latents,
    keeping the main pass's "unet" residuals (a ControlNet's, say) aside."""

    def __init__(self, target: SD1UNet) -> None:
        guide_unet = target.structural_copy()
        for i, attention_block in enumerate(guide_unet.layers(CrossAttentionBlock)):
            sa = attention_block.ensure_find(SelfAttention)
            assert sa.parent is not None
            SaveLayerNormAdapter(sa, context=f"self_attention_context_{i}").inject()

        super().__init__(
            Lambda(self._copy_diffusion_context),
            UseContext("reference_only_control", "guide"),
            guide_unet,
            Lambda(self._restore_diffusion_context),
        )

    def _copy_diffusion_context(self, x: torch.Tensor) -> torch.Tensor:
        # the residual accumulation of the main pass (e.g. ControlNets) is kept aside
        self.set_context("self_attention_residuals_buffer", {"buffer": self.use_context("unet")["residuals"]})
        self.set_context("unet", {"residuals": [0.0] * 13})
        return x

    def _restore_diffusion_context(self, x: torch.Tensor) -> torch.Tensor:
        self.set_context("unet", {"residuals": self.use_context("self_attention_residuals_buffer")["buffer"]})
        return x


class ReferenceOnlyControlAdapter(Chain, Adapter[SD1UNet]):
    """Reference-only control on an SD1.5 UNet (4 or 9 channels). The guide
    pass and the per-attention adapters are kept out of the adapter's
    registration (lists), as the JAX package keeps them out of its pytree:
    the guide UNet shares the target's weights and adds none."""

    def __init__(self, target: SD1UNet, style_cfg: float = 0.5) -> None:
        # style_cfg weights the guide in the unconditional sample (0.5, as sd-webui)
        self.sub_adapters: list[SelfAttentionInjectionAdapter] = []
        self._passthrough: list[SelfAttentionInjectionPassthrough] = [SelfAttentionInjectionPassthrough(target)]

        with self.setup_adapter(target):
            super().__init__(target)

        for i, attention_block in enumerate(target.layers(CrossAttentionBlock)):
            self.set_context(f"self_attention_context_{i}", {"norm": None})
            sa = attention_block.ensure_find(SelfAttention)
            assert sa.parent is not None
            self.sub_adapters.append(
                SelfAttentionInjectionAdapter(sa, context=f"self_attention_context_{i}", style_cfg=style_cfg)
            )

    def inject(self: "ReferenceOnlyControlAdapter", parent: Chain | None = None) -> "ReferenceOnlyControlAdapter":
        passthrough = self._passthrough[0]
        assert passthrough not in self.target, f"{passthrough} is already injected"
        for adapter in self.sub_adapters:
            adapter.inject()
        self.target.insert(0, passthrough)
        return super().inject(parent)

    def eject(self) -> None:
        passthrough = self._passthrough[0]
        assert self.target[0] is passthrough, f"{passthrough} is not the first element of target UNet"
        for adapter in self.sub_adapters:
            adapter.eject()
        self.target.pop(0)
        super().eject()

    def set_controlnet_condition(self, condition: torch.Tensor) -> None:
        """The guide's noised latents, CFG batch (2, C, H, W) with the UNet's
        channels; cast to the UNet's device and dtype."""
        condition = condition.to(device=self.target.device, dtype=self.target.dtype)
        self.set_context("reference_only_control", {"guide": condition})

    def structural_copy(self: "ReferenceOnlyControlAdapter") -> "ReferenceOnlyControlAdapter":
        raise RuntimeError("ReferenceOnlyControlAdapter cannot be copied, eject it first.")
