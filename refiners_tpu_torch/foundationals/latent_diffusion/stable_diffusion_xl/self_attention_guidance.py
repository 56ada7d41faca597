"""SDXL's self-attention guidance adapter; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/self_attention_guidance.py``.

It records the shape after the middle block's first ResidualBlock and the
attention map of the middle block's first self-attention (20 heads at full
width), just before its scaled dot-product attention."""

from __future__ import annotations

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.foundationals.latent_diffusion.self_attention_guidance import (
    SAGAdapter,
    SelfAttentionMap,
    SelfAttentionShape,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import (
    MiddleBlock,
    ResidualBlock,
    SDXLUNet,
)


class SDXLSAGAdapter(SAGAdapter[SDXLUNet]):
    def __init__(self, target: SDXLUNet, scale: float = 1.0, kernel_size: int = 9, sigma: float = 1.0) -> None:
        super().__init__(target=target, scale=scale, kernel_size=kernel_size, sigma=sigma)

    def inject(self: "SDXLSAGAdapter", parent: fl.Chain | None = None) -> "SDXLSAGAdapter":
        middle_block = self.target.ensure_find(MiddleBlock)
        middle_block.insert_after_type(ResidualBlock, SelfAttentionShape(context_key="middle_block_attn_shape"))

        self_attn = middle_block.ensure_find(fl.SelfAttention)
        self_attn.insert_before_type(
            fl.ScaledDotProductAttention,
            SelfAttentionMap(num_heads=self_attn.num_heads, context_key="middle_block_attn_map"),
        )
        return super().inject(parent)

    def eject(self) -> None:
        middle_block = self.target.ensure_find(MiddleBlock)
        middle_block.remove(middle_block.ensure_find(SelfAttentionShape))

        self_attn = middle_block.ensure_find(fl.SelfAttention)
        self_attn.remove(self_attn.ensure_find(SelfAttentionMap))
        super().eject()
