"""Text-to-image pipeline on one device; counterpart of ``refiners_tpu/pipelines.py``.

Bundles prompt encoding, the denoising loop and the VAE decode under
``torch.inference_mode()``. The JAX pipeline's mesh branch (data and tensor
parallelism) waits for the port of ``parallel/``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.utils import tensor_to_images
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import StableDiffusion_XL


@dataclass
class TextToImage:
    """Text-to-image for SD1.5 / SDXL on the model's device.

    Example:
        pipe = TextToImage(sd15)
        image = pipe("a cute cat", negative_prompt="low quality", seed=42)

    `num_images` latents are denoised as one batch (CFG batch 2 × `num_images`).
    """

    sd: LatentDiffusionModel
    size: tuple[int, int] = (512, 512)
    condition_scale: float | None = None
    num_images: int = 1

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        seed: int | None = None,
        condition_scale: float | None = None,
    ) -> Image.Image | list[Image.Image]:
        """Generate `num_images` images (a single Image when 1). The noise,
        and a stochastic solver's draws, come from a generator on the model's
        device seeded by `seed` (else the device's seeded generator)."""
        sd = self.sd
        device, dtype = sd.unet.device, sd.unet.dtype
        generator = torch.Generator(device).manual_seed(seed) if seed is not None else rng.generator(device)
        n = self.num_images
        h, w = self.size
        noise = torch.randn((n, 4, h // 8, w // 8), generator=generator, device=device, dtype=torch.float32)
        x = sd.solver.scale_model_input(noise.to(dtype), step=-1)

        # (2, ...) [uncond, cond] → (2n, ...) [uncond×n, cond×n]: the layout of
        # predict_noise's cat((x, x)) CFG batch
        kwargs: dict[str, Any] = {}
        if isinstance(sd, StableDiffusion_XL):
            scale = condition_scale or self.condition_scale or 5.0
            emb, pooled = sd.compute_clip_text_embedding(prompt, negative_prompt)
            kwargs = {
                "pooled_text_embedding": pooled.repeat_interleave(n, dim=0),
                "time_ids": sd.default_time_ids.repeat_interleave(n, dim=0),
            }
        else:
            scale = condition_scale or self.condition_scale or 7.5
            emb = sd.compute_clip_text_embedding(prompt, negative_prompt)
        z = sd.diffuse(
            x, clip_text_embedding=emb.repeat_interleave(n, dim=0), condition_scale=scale, generator=generator, **kwargs
        )
        images = tensor_to_images((sd.lda.decode(z) + 1) / 2)
        return images[0] if n == 1 else images
