"""Stable Diffusion XL model facade; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/model.py``.

Self-attention guidance is an `SDXLSAGAdapter` around the UNet:
`set_self_attention_guidance(True)` injects it, and each step then makes a
second UNet call at batch 1 on the degraded latents.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DDIM, Solver
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.self_attention_guidance import SDXLSAGAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import DoubleTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet


class SDXLAutoencoder(LatentDiffusionAutoencoder):
    """SDXL VAE: latent scale 0.13025."""

    encoder_scale: float = 0.13025


class StableDiffusion_XL(LatentDiffusionModel):
    """SDXL: DoubleTextEncoder + SDXLUNet + VAE; default DDIM 30 steps, CFG 5.0.

    Builds on the card unless `device` says otherwise (``device="cpu"``)."""

    unet: SDXLUNet
    clip_text_encoder: DoubleTextEncoder
    lda: SDXLAutoencoder

    def __init__(
        self,
        unet: SDXLUNet | None = None,
        lda: SDXLAutoencoder | None = None,
        clip_text_encoder: DoubleTextEncoder | None = None,
        solver: Solver | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        device = default_device(device)
        super().__init__(
            unet=unet or SDXLUNet(in_channels=4, device=device, dtype=dtype),
            lda=lda or SDXLAutoencoder(device=device, dtype=dtype),
            clip_text_encoder=clip_text_encoder or DoubleTextEncoder(device=device, dtype=dtype),
            solver=solver or DDIM(num_inference_steps=30, device=device),
            device=device,
            dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        pooled_text_embedding: torch.Tensor,
        time_ids: torch.Tensor,
        condition_scale: float = 5.0,
        **kwargs: Any,
    ) -> torch.Tensor:
        return super().forward(
            x,
            step,
            clip_text_embedding=clip_text_embedding,
            pooled_text_embedding=pooled_text_embedding,
            time_ids=time_ids,
            condition_scale=condition_scale,
            **kwargs,
        )

    def compute_clip_text_embedding(
        self, text: str | list[str], negative_text: str | list[str] = ""
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Text + pooled embedding, the negative prompt stacked first for CFG."""
        text = [text] if isinstance(text, str) else text
        if not self.classifier_free_guidance:
            return self.clip_text_encoder(text)
        negative_text = [negative_text] if isinstance(negative_text, str) else negative_text
        assert len(text) == len(negative_text), "The length of the text list and negative_text should be the same"

        conditional_embedding, conditional_pooled = self.clip_text_encoder(text)
        negative_embedding, negative_pooled = self.clip_text_encoder(negative_text)
        return (
            torch.cat((negative_embedding, conditional_embedding), dim=0),
            torch.cat((negative_pooled, conditional_pooled), dim=0),
        )

    @property
    def default_time_ids(self) -> torch.Tensor:
        """[orig_h, orig_w, crop_top, crop_left, target_h, target_w]
        micro-conditioning (arXiv:2307.01952 §2.2), on the unet's device."""
        time_ids = torch.tensor([[1024, 1024, 0, 0, 1024, 1024]], device=self.unet.device)
        return time_ids.repeat(2 if self.classifier_free_guidance else 1, 1)

    def set_unet_context(
        self,
        *,
        timestep: torch.Tensor,
        clip_text_embedding: torch.Tensor,
        pooled_text_embedding: torch.Tensor,
        time_ids: torch.Tensor,
        **_: Any,
    ) -> None:
        self.unet.set_timestep(timestep=timestep)
        self.unet.set_clip_text_embedding(clip_text_embedding=clip_text_embedding)
        self.unet.set_pooled_text_embedding(pooled_text_embedding=pooled_text_embedding)
        self.unet.set_time_ids(time_ids=time_ids)

    def set_self_attention_guidance(self, enable: bool, scale: float = 1.0) -> None:
        if enable:
            if sag := self._find_sag_adapter():
                sag.scale = scale
            else:
                SDXLSAGAdapter(target=self.unet, scale=scale).inject()
        else:
            if sag := self._find_sag_adapter():
                sag.eject()

    def has_self_attention_guidance(self) -> bool:
        return self._find_sag_adapter() is not None

    def _find_sag_adapter(self) -> SDXLSAGAdapter | None:
        for p in self.unet.get_parents():
            if isinstance(p, SDXLSAGAdapter):
                return p
        return None

    def compute_self_attention_guidance(
        self,
        x: torch.Tensor,
        noise: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        pooled_text_embedding: torch.Tensor,
        time_ids: torch.Tensor,
        **kwargs: Any,
    ) -> torch.Tensor:
        """SAG's term: its scale times the unconditional noise less the
        noise predicted, unconditioned, on the degraded latents (the negative
        halves of the text embedding, the pooled embedding, the time ids and,
        with an IP-Adapter, the image tokens)."""
        sag = self._find_sag_adapter()
        assert sag is not None

        degraded_latents = sag.compute_degraded_latents(
            solver=self.solver, latents=x, noise=noise, step=step, classifier_free_guidance=True
        )
        timestep = self.solver.timesteps[step][None]
        self.set_unet_context(
            timestep=timestep,
            clip_text_embedding=clip_text_embedding.chunk(2)[0],
            pooled_text_embedding=pooled_text_embedding.chunk(2)[0],
            time_ids=time_ids.chunk(2)[0],
        )
        if "ip_adapter" in self.unet.provider.contexts:
            ip_adapter_context = self.unet.use_context("ip_adapter")
            image_embedding = ip_adapter_context["clip_image_embedding"]
            ip_adapter_context["clip_image_embedding"] = image_embedding.chunk(2)[0]
            degraded_noise = self.unet(degraded_latents)
            ip_adapter_context["clip_image_embedding"] = image_embedding
        else:
            degraded_noise = self.unet(degraded_latents)
        return sag.scale * (noise - degraded_noise)
