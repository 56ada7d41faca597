"""Clarity-style tiled upscaler: a tile ControlNet, LoRAs and a negative
textual-inversion embedding on SD1.5, diffused over overlapping tiles
(MultiDiffusion) between a tiled VAE encode and decode; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/multi_upscaler.py``.

Checkpoints are safetensors files in the port's (torch) layout. The noise is
drawn from a `torch.Generator` where the JAX package takes a key, through
`_upscale_noise`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence, TypeVar

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.utils import default_device, image_to_tensor, load_from_safetensors, load_tensors
from refiners_tpu_torch.foundationals.clip.concepts import ConceptExtender
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import DiffusionTarget, MultiDiffusion, Size
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DPMSolver, Solver
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import SD1ControlnetAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import StableDiffusion_1

Name = str


@dataclass(kw_only=True)
class UpscalerCheckpoints:
    """Checkpoint paths for the multi-upscaler."""

    unet: Path
    clip_text_encoder: Path
    lda: Path
    controlnet_tile: Path
    negative_embedding: Path | None = None
    negative_embedding_key: str | None = None
    loras: dict[Name, Path] | None = None


@dataclass(kw_only=True)
class UpscalerTarget(DiffusionTarget):
    clip_text_embedding: torch.Tensor
    controlnet_condition: torch.Tensor = None  # type: ignore[assignment]
    condition_scale: float = 7.0


T = TypeVar("T", bound=DiffusionTarget)


class MultiUpscalerAbstract(MultiDiffusion[T], ABC):
    """Builds on the card unless `device` says otherwise."""

    def __init__(self, checkpoints: UpscalerCheckpoints, device: Any = None, dtype: Any = None) -> None:
        self.device = default_device(device)
        self.dtype = dtype
        self.sd = self.load_stable_diffusion(checkpoints)
        self.manager = self.load_loras(checkpoints.loras)
        self.controlnet = self.load_controlnet(checkpoints)
        self.negative_embedding_token = self.load_negative_embedding(
            checkpoints.negative_embedding, checkpoints.negative_embedding_key
        )

    @abstractmethod
    def compute_targets(
        self,
        image: Image.Image,
        latent_size: Size,
        tile_size: Size,
        num_inference_steps: int,
        first_step: int,
        condition_scale: float,
        clip_text_embedding: torch.Tensor,
    ) -> Sequence[T]: ...

    @abstractmethod
    def diffuse_target(self, x: torch.Tensor, step: int, target: T) -> torch.Tensor: ...

    def load_stable_diffusion(self, checkpoints: UpscalerCheckpoints) -> StableDiffusion_1:
        sd = StableDiffusion_1(device=self.device, dtype=self.dtype)
        sd.unet.load_from_safetensors(checkpoints.unet)
        sd.clip_text_encoder.load_from_safetensors(checkpoints.clip_text_encoder)
        sd.lda.load_from_safetensors(checkpoints.lda)
        return sd

    def load_controlnet(self, checkpoints: UpscalerCheckpoints) -> SD1ControlnetAdapter:
        return SD1ControlnetAdapter(
            target=self.sd.unet,
            name="tile",
            weights=load_from_safetensors(checkpoints.controlnet_tile),
        ).inject()

    def load_loras(self, loras: dict[Name, Path] | None) -> SDLoraManager | None:
        if loras is None:
            return None
        manager = SDLoraManager(self.sd)
        for name, path in loras.items():
            manager.add_loras(name, tensors=load_from_safetensors(path))
        return manager

    def load_negative_embedding(self, path: Path | None, key: str | None) -> str:
        """Add each row of a textual-inversion negative embedding to CLIP as
        a token "<i>"; the tokens, appended to every negative prompt."""
        if path is None:
            return ""

        embeddings: Any = load_tensors(path) if str(path).endswith((".pt", ".bin")) else load_from_safetensors(path)
        if isinstance(embeddings, dict):
            assert key is not None, "Key must be provided to access the negative embedding."
            for k in key.split("."):
                assert k in embeddings, f"Key {k} not found; available: {list(embeddings.keys())}"
                embeddings = embeddings[k]

        assert isinstance(embeddings, torch.Tensor), f"The negative embedding must be a tensor, found {type(embeddings)}."
        assert embeddings.ndim == 2, f"The negative embedding must be a 2D tensor, found {embeddings.ndim}D."

        extender = ConceptExtender(self.sd.clip_text_encoder)
        negative_embedding_token = ", "
        for i, embedding in enumerate(embeddings):
            extender.add_concept(token=f"<{i}>", embedding=embedding)
            negative_embedding_token += f"<{i}> "
        extender.inject()
        return negative_embedding_token

    def compute_clip_text_embedding(self, prompt: str, negative_prompt: str, offload_to_cpu: bool = True) -> torch.Tensor:
        if self.negative_embedding_token:
            negative_prompt += self.negative_embedding_token
        return self.sd.compute_clip_text_embedding(text=prompt, negative_text=negative_prompt)

    def diffuse_upscaler_target(self, x: torch.Tensor, step: int, target: UpscalerTarget) -> torch.Tensor:
        """One step of the tile: its solver, its ControlNet condition, its text."""
        self.sd.solver = target.solver
        self.controlnet.set_controlnet_condition(target.controlnet_condition)
        return self.sd(
            x, step, clip_text_embedding=target.clip_text_embedding, condition_scale=target.condition_scale
        )

    def pre_upscale(self, image: Image.Image, upscale_factor: float) -> Image.Image:
        """LANCZOS resize to a multiple of 8; override for an ESRGAN-style pre-upscale."""
        return image.resize(
            (int((image.width * upscale_factor) // 8 * 8), int((image.height * upscale_factor) // 8 * 8)),
            resample=Image.Resampling.LANCZOS,
        )

    def compute_upscaler_targets(
        self,
        image: Image.Image,
        latent_size: Size,
        tile_size: Size,
        num_inference_steps: int,
        first_step: int,
        condition_scale: float,
        clip_text_embedding: torch.Tensor,
    ) -> Sequence[UpscalerTarget]:
        """One target per MultiDiffusion tile, each with its own solver and
        its crop of the image as the ControlNet condition."""
        tiles = MultiDiffusion.generate_latent_tiles(size=latent_size, tile_size=tile_size, min_overlap=8)
        targets: list[UpscalerTarget] = []
        for tile in tiles:
            pixel_box = (tile.left * 8, tile.top * 8, tile.right * 8, tile.bottom * 8)
            pixel_tile = image.crop(pixel_box)
            solver = self.sd.solver.rebuild(num_inference_steps=num_inference_steps, first_inference_step=first_step)
            targets.append(
                UpscalerTarget(
                    tile=tile,
                    solver=solver,
                    start_step=first_step,
                    condition_scale=condition_scale,
                    controlnet_condition=image_to_tensor(pixel_tile, device=self.sd.unet.device, dtype=self.dtype),
                    clip_text_embedding=clip_text_embedding,
                )
            )
        return targets

    def diffuse_targets(
        self,
        noise: torch.Tensor,
        targets: Sequence[T],
        image: Image.Image,
        first_step: int,
        autoencoder_tile_length: int,
    ) -> Image.Image:
        """The image encoded tile by tile, noised to `first_step`, diffused
        over the targets to the last step, and decoded tile by tile."""
        with self.sd.lda.tiled_inference(image, (autoencoder_tile_length, autoencoder_tile_length)):
            latents = self.sd.lda.tiled_image_to_latents(image)
            x = self.sd.solver.add_noise(latents, noise, first_step)
            for step in self.sd.steps:
                x = self(x, noise=noise, step=step, targets=targets)
            return self.sd.lda.tiled_latents_to_image(x)

    def _upscale_noise(self, generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
        """Standard normal float32 noise of the latents' `shape`, from
        `generator` (else the device's seeded generator). A method of its own
        so that tests can inject another noise."""
        device = self.sd.unet.device
        generator = generator if generator is not None else rng.generator(device)
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    @torch.inference_mode()
    def upscale(
        self,
        image: Image.Image,
        prompt: str = "masterpiece, best quality, highres",
        negative_prompt: str = "worst quality, low quality, normal quality",
        upscale_factor: float = 2,
        tile_size: tuple[int, int] = (144, 112),
        denoise_strength: float = 0.35,
        condition_scale: float = 6,
        controlnet_scale: float = 0.6,
        controlnet_scale_decay: float = 0.825,
        loras_scale: dict[Name, float] | None = None,
        solver_type: type[Solver] = DPMSolver,
        num_inference_steps: int = 18,
        autoencoder_tile_length: int = 1024,
        generator: torch.Generator | None = None,
    ) -> Image.Image:
        """Upscale an image; the defaults are clarity-upscaler's."""
        self.controlnet.scale = controlnet_scale
        self.controlnet.scale_decay = controlnet_scale_decay

        if self.manager is not None and loras_scale is not None:
            self.manager.update_scales(loras_scale)

        first_step = int(num_inference_steps * (1 - denoise_strength))
        self.sd.solver = solver_type(
            num_inference_steps=num_inference_steps, first_inference_step=first_step, device=self.sd.unet.device
        )

        clip_text_embedding = self.compute_clip_text_embedding(prompt=prompt, negative_prompt=negative_prompt)

        image = self.pre_upscale(image, upscale_factor=upscale_factor)
        assert image.width % 8 == 0 and image.height % 8 == 0, "rescaled image dimensions must be divisible by 8"

        latent_size = Size(height=image.height // 8, width=image.width // 8)
        tile_size = Size(height=tile_size[0], width=tile_size[1])

        targets: Sequence[DiffusionTarget] = self.compute_targets(
            image=image,
            latent_size=latent_size,
            tile_size=tile_size,
            num_inference_steps=num_inference_steps,
            first_step=first_step,
            condition_scale=condition_scale,
            clip_text_embedding=clip_text_embedding,
        )

        noise = self._upscale_noise(generator, (1, 4, latent_size.height, latent_size.width))
        noise = noise.to(self.dtype or torch.float32)

        return self.diffuse_targets(
            noise=noise,
            targets=targets,
            image=image,
            first_step=first_step,
            autoencoder_tile_length=autoencoder_tile_length,
        )


class MultiUpscaler(MultiUpscalerAbstract[UpscalerTarget]):
    def diffuse_target(self, x: torch.Tensor, step: int, target: UpscalerTarget) -> torch.Tensor:
        return self.diffuse_upscaler_target(x=x, step=step, target=target)

    def compute_targets(
        self,
        image: Image.Image,
        latent_size: Size,
        tile_size: Size,
        num_inference_steps: int,
        first_step: int,
        condition_scale: float,
        clip_text_embedding: torch.Tensor,
    ) -> Sequence[UpscalerTarget]:
        return self.compute_upscaler_targets(
            image=image,
            latent_size=latent_size,
            tile_size=tile_size,
            num_inference_steps=num_inference_steps,
            first_step=first_step,
            condition_scale=condition_scale,
            clip_text_embedding=clip_text_embedding,
        )
