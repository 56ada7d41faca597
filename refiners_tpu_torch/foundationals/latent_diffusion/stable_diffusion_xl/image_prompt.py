"""SDXL's IP-Adapter; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/image_prompt.py``.

The image encoder (ViT-H, 632 M parameters, when none is given) and the
projection are built on the UNet's device and in its dtype."""

from __future__ import annotations

import torch

from refiners_tpu_torch.foundationals.clip.image_encoder import CLIPImageEncoderH
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock2d
from refiners_tpu_torch.foundationals.latent_diffusion.image_prompt import (
    ImageProjection,
    IPAdapter,
    PerceiverResampler,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet


class SDXLIPAdapter(IPAdapter[SDXLUNet]):
    """IP-Adapter (`fine_grained=False`: 4 tokens of 2048 from the pooled
    embedding) or IP-Adapter plus (`fine_grained=True`: 16 tokens from the
    grid features through a 4-layer perceiver resampler of width 1280)."""

    def __init__(
        self,
        target: SDXLUNet,
        clip_image_encoder: CLIPImageEncoderH | None = None,
        image_proj: ImageProjection | PerceiverResampler | None = None,
        scale: float = 1.0,
        fine_grained: bool = False,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        device, dtype = target.device, target.dtype
        if clip_image_encoder is None:
            clip_image_encoder = CLIPImageEncoderH(device=device, dtype=dtype)
        if image_proj is None:
            cross_attn_2d = target.ensure_find(CrossAttentionBlock2d)
            image_proj = (
                ImageProjection(
                    clip_image_embedding_dim=clip_image_encoder.output_dim,
                    clip_text_embedding_dim=cross_attn_2d.context_embedding_dim,
                    device=device,
                    dtype=dtype,
                )
                if not fine_grained
                else PerceiverResampler(
                    latents_dim=1280,  # not the context width (2048), as SD1.5's is
                    num_attention_layers=4,
                    num_attention_heads=20,
                    head_dim=64,
                    num_tokens=16,
                    input_dim=clip_image_encoder.embedding_dim,  # the width before the final projection
                    output_dim=cross_attn_2d.context_embedding_dim,
                    device=device,
                    dtype=dtype,
                )
            )
        elif fine_grained:
            assert isinstance(image_proj, PerceiverResampler)
        super().__init__(
            target=target,
            clip_image_encoder=clip_image_encoder,
            image_proj=image_proj,
            scale=scale,
            fine_grained=fine_grained,
            weights=weights,
        )
