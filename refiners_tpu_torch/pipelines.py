"""Text-to-image pipeline on one device; counterpart of ``refiners_tpu/pipelines.py``.

Bundles prompt encoding, the denoising loop and the VAE decode under
``torch.inference_mode()``. The JAX pipeline's mesh branch (data and tensor
parallelism) waits for the port of ``parallel/``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.utils import tensor_to_image
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import StableDiffusion_XL


@dataclass
class TextToImage:
    """Text-to-image for SDXL on the model's device.

    Example:
        pipe = TextToImage(sdxl, size=(1024, 1024))
        image = pipe("a cute cat", negative_prompt="low quality", seed=42)
    """

    sd: LatentDiffusionModel
    size: tuple[int, int] = (512, 512)
    condition_scale: float | None = None

    def __post_init__(self) -> None:
        if not isinstance(self.sd, StableDiffusion_XL):
            raise NotImplementedError("refiners_tpu_torch's TextToImage supports StableDiffusion_XL only so far")

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        seed: int | None = None,
        condition_scale: float | None = None,
    ) -> Image.Image:
        """Generate one image."""
        sd = self.sd
        assert isinstance(sd, StableDiffusion_XL)
        device, dtype = sd.unet.device, sd.unet.dtype
        generator = torch.Generator(device).manual_seed(seed) if seed is not None else rng.generator(device)
        h, w = self.size
        noise = torch.randn((1, 4, h // 8, w // 8), generator=generator, device=device, dtype=torch.float32)
        x = sd.solver.scale_model_input(noise.to(dtype), step=-1)

        scale = condition_scale or self.condition_scale or 5.0
        # (2, ...) [uncond, cond]: the layout of predict_noise's cat((x, x)) CFG batch
        emb, pooled = sd.compute_clip_text_embedding(prompt, negative_prompt)
        z = sd.diffuse(
            x, clip_text_embedding=emb, pooled_text_embedding=pooled, time_ids=sd.default_time_ids, condition_scale=scale
        )
        return tensor_to_image((sd.lda.decode(z) + 1) / 2)
