"""Stable Diffusion 1.5 model facades; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/model.py``.

Self-attention guidance is an `SD1SAGAdapter` around the UNet:
`set_self_attention_guidance(True)` injects it, and each step then makes a
second UNet call at batch 1 on the degraded latents.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from PIL import Image

from refiners_tpu_torch.fluxion.utils import default_device, image_to_tensor, interpolate
from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoderL
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DPMSolver, Solver
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.self_attention_guidance import SD1SAGAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet


class SD1Autoencoder(LatentDiffusionAutoencoder):
    """SD1.5 VAE: latent scale 0.18215."""

    encoder_scale: float = 0.18215


class StableDiffusion_1(LatentDiffusionModel):
    """SD1.5: CLIP-L + SD1UNet + VAE; default DPM++ 30 steps, CFG 7.5.

    Builds on the card unless `device` says otherwise (``device="cpu"``)."""

    unet: SD1UNet
    clip_text_encoder: CLIPTextEncoderL
    lda: SD1Autoencoder

    def __init__(
        self,
        unet: SD1UNet | None = None,
        lda: SD1Autoencoder | None = None,
        clip_text_encoder: CLIPTextEncoderL | None = None,
        solver: Solver | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        device = default_device(device)
        super().__init__(
            unet=unet if unet is not None else SD1UNet(in_channels=4, device=device, dtype=dtype),
            lda=lda if lda is not None else SD1Autoencoder(device=device, dtype=dtype),
            clip_text_encoder=(
                clip_text_encoder if clip_text_encoder is not None else CLIPTextEncoderL(device=device, dtype=dtype)
            ),
            solver=solver if solver is not None else DPMSolver(num_inference_steps=30, device=device),
            device=device,
            dtype=dtype,
        )

    def forward(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        **kwargs: Any,
    ) -> torch.Tensor:
        return super().forward(
            x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
        )

    def compute_clip_text_embedding(self, text: str | list[str], negative_text: str | list[str] = "") -> torch.Tensor:
        """The text embedding, the negative prompt's stacked first for CFG."""
        text = [text] if isinstance(text, str) else text
        if not self.classifier_free_guidance:
            return self.clip_text_encoder(text)
        negative_text = [negative_text] if isinstance(negative_text, str) else negative_text
        assert len(text) == len(negative_text), "The length of the text list and negative_text should be the same"
        conditional_embedding = self.clip_text_encoder(text)
        negative_embedding = self.clip_text_encoder(negative_text)
        return torch.cat((negative_embedding, conditional_embedding), dim=0)

    def set_unet_context(self, *, timestep: torch.Tensor, clip_text_embedding: torch.Tensor, **_: Any) -> None:
        self.unet.set_timestep(timestep=timestep)
        self.unet.set_clip_text_embedding(clip_text_embedding=clip_text_embedding)

    def set_self_attention_guidance(self, enable: bool, scale: float = 1.0) -> None:
        if enable:
            if sag := self._find_sag_adapter():
                sag.scale = scale
            else:
                SD1SAGAdapter(target=self.unet, scale=scale).inject()
        else:
            if sag := self._find_sag_adapter():
                sag.eject()

    def has_self_attention_guidance(self) -> bool:
        return self._find_sag_adapter() is not None

    def _find_sag_adapter(self) -> SD1SAGAdapter | None:
        for p in self.unet.get_parents():
            if isinstance(p, SD1SAGAdapter):
                return p
        return None

    def compute_self_attention_guidance(
        self, x: torch.Tensor, noise: torch.Tensor, step: int, *, clip_text_embedding: torch.Tensor, **kwargs: Any
    ) -> torch.Tensor:
        """SAG's term: its scale times the unconditional noise less the
        noise predicted, unconditioned, on the degraded latents (the negative
        half of the text embedding and, with an IP-Adapter, of the image
        tokens)."""
        sag = self._find_sag_adapter()
        assert sag is not None
        degraded_latents = sag.compute_degraded_latents(
            solver=self.solver, latents=x, noise=noise, step=step, classifier_free_guidance=True
        )
        timestep = self.solver.timesteps[step][None]
        negative_embedding = clip_text_embedding.chunk(2)[0]
        self.set_unet_context(timestep=timestep, clip_text_embedding=negative_embedding, **kwargs)
        if "ip_adapter" in self.unet.provider.contexts:
            ip_adapter_context = self.unet.use_context("ip_adapter")
            image_embedding = ip_adapter_context["clip_image_embedding"]
            ip_adapter_context["clip_image_embedding"] = image_embedding.chunk(2)[0]
            degraded_noise = self.unet(degraded_latents)
            ip_adapter_context["clip_image_embedding"] = image_embedding
        else:
            degraded_noise = self.unet(degraded_latents)
        return sag.scale * (noise - degraded_noise)


class StableDiffusion_1_Inpainting(StableDiffusion_1):
    """SD1.5 inpainting: a 9-channel UNet that takes, besides the latents, the
    mask and the masked image's latents on the channel axis."""

    def __init__(
        self,
        unet: SD1UNet | None = None,
        lda: SD1Autoencoder | None = None,
        clip_text_encoder: CLIPTextEncoderL | None = None,
        solver: Solver | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.mask_latents: torch.Tensor | None = None
        self.target_image_latents: torch.Tensor | None = None
        device = default_device(device)
        super().__init__(
            unet=unet if unet is not None else SD1UNet(in_channels=9, device=device, dtype=dtype),
            lda=lda,
            clip_text_encoder=clip_text_encoder,
            solver=solver,
            device=device,
            dtype=dtype,
        )

    def predict_noise(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        **_: Any,
    ) -> torch.Tensor:
        assert self.mask_latents is not None
        assert self.target_image_latents is not None
        # the mask and the masked image's latents join the latents at every step
        x = torch.cat((x[:, :4], self.mask_latents, self.target_image_latents), dim=1)
        return super().predict_noise(x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale)

    def set_inpainting_conditions(
        self,
        target_image: Image.Image,
        mask: Image.Image,
        latents_size: tuple[int, int] = (64, 64),
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The mask (white: repaint) at latent size, and the latents of the
        target image with the masked region set to 0 (grey)."""
        device, dtype = self.unet.device, self.unet.dtype
        target_image = target_image.convert(mode="RGB")
        mask = mask.convert(mode="L")

        mask_tensor = torch.tensor(np.array(mask).astype(np.float32) / 255.0, device=device)
        mask_tensor = (mask_tensor > 0.5)[None, None].to(dtype)
        self.mask_latents = interpolate(mask_tensor, latents_size)

        init_image_tensor = image_to_tensor(target_image, device=device, dtype=dtype) * 2 - 1
        masked_init_image = init_image_tensor * (1 - mask_tensor)
        self.target_image_latents = self.lda.encode(masked_init_image)
        return self.mask_latents, self.target_image_latents

    def compute_self_attention_guidance(
        self, x: torch.Tensor, noise: torch.Tensor, step: int, *, clip_text_embedding: torch.Tensor, **kwargs: Any
    ) -> torch.Tensor:
        """As the text-to-image model's, with the mask and the masked image's
        latents joined to the degraded latents (and, as in the JAX package,
        no split of an IP-Adapter's image tokens)."""
        sag = self._find_sag_adapter()
        assert sag is not None
        assert self.mask_latents is not None
        assert self.target_image_latents is not None
        degraded_latents = sag.compute_degraded_latents(
            solver=self.solver, latents=x, noise=noise, step=step, classifier_free_guidance=True
        )
        degraded = torch.cat((degraded_latents, self.mask_latents, self.target_image_latents), dim=1)
        timestep = self.solver.timesteps[step][None]
        self.set_unet_context(timestep=timestep, clip_text_embedding=clip_text_embedding.chunk(2)[0], **kwargs)
        return sag.scale * (noise - self.unet(degraded))
