"""LatentDiffusionModel base; counterpart of
``refiners_tpu/foundationals/latent_diffusion/model.py``.

Owns the unet, the VAE (`lda`), the text encoder and the solver. `forward` is
one denoising step (context set → CFG batch → unet → guidance → solver
update); `diffuse` is the whole loop, a Python loop over the steps that
carries (latents, solver state) where the JAX package runs a `lax.scan`.
Latents are NCHW. Stochastic solvers draw from the `generator` that
`forward` and `diffuse` take, where the JAX package threads a PRNG key.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, TypeVar

import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import Solver

TLatentDiffusionModel = TypeVar("TLatentDiffusionModel", bound="LatentDiffusionModel")


class LatentDiffusionModel(fl.Module, ABC):
    def __init__(
        self,
        unet: fl.Chain,
        lda: LatentDiffusionAutoencoder,
        clip_text_encoder: fl.Chain,
        solver: Solver,
        classifier_free_guidance: bool = True,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        device = default_device(device)
        self.unet = unet.to(device=device, dtype=dtype)
        self.lda = lda.to(device=device, dtype=dtype)
        self.clip_text_encoder = clip_text_encoder.to(device=device, dtype=dtype)
        self.solver = solver.to(device=device)
        self.classifier_free_guidance = classifier_free_guidance

    def set_inference_steps(self, num_steps: int, first_step: int = 0) -> None:
        """Set the step count; `first_step = round((1-strength)·(num_steps-1))` for img2img."""
        self.solver = self.solver.rebuild(num_inference_steps=num_steps, first_inference_step=first_step)

    @staticmethod
    def sample_noise(
        size: tuple[int, ...],
        device: Any = None,
        dtype: Any = None,
        offset_noise: float | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Gaussian noise of NCHW `size`, drawn in float32 from `generator`
        (else the seeded generator of `device`, `fluxion.rng`); with offset
        noise, one more draw per (batch, channel)."""
        generator = generator if generator is not None else rng.generator(device)
        noise = torch.randn(size, generator=generator, device=device, dtype=torch.float32)
        if offset_noise is not None:
            b, c = size[0], size[1]
            offset = torch.randn((b, c, 1, 1), generator=generator, device=device, dtype=torch.float32)
            noise = noise + offset_noise * offset
        return noise.to(dtype or torch.float32)

    def init_latents(
        self,
        size: tuple[int, int],
        init_image: Image.Image | None = None,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Fresh latents, or img2img: `init_image` encoded and noised to the
        solver's first inference step; scaled for the solver's first step."""
        height, width = size
        latent_height, latent_width = height // 8, width // 8
        if noise is None:
            noise = self.sample_noise(
                (1, 4, latent_height, latent_width), device=self.unet.device, dtype=self.unet.dtype, generator=generator
            )
        assert tuple(noise.shape[2:4]) == (
            latent_height,
            latent_width,
        ), f"noise shape is not compatible: {tuple(noise.shape)}, with size: {size}"
        if init_image is None:
            latent = noise
        else:
            encoded_image = self.lda.image_to_latents(init_image.resize(size=(width, height)))
            latent = self.solver.add_noise(encoded_image, noise, self.solver.first_inference_step)
        return self.solver.scale_model_input(latent, step=-1)

    @property
    def steps(self) -> list[int]:
        return self.solver.inference_steps

    @abstractmethod
    def set_unet_context(
        self, *, timestep: torch.Tensor, clip_text_embedding: torch.Tensor, **_: torch.Tensor
    ) -> None: ...

    @abstractmethod
    def set_self_attention_guidance(self, enable: bool, scale: float = 1.0) -> None: ...

    @abstractmethod
    def has_self_attention_guidance(self) -> bool: ...

    @abstractmethod
    def compute_self_attention_guidance(
        self, x: torch.Tensor, noise: torch.Tensor, step: int, *, clip_text_embedding: torch.Tensor, **kwargs: Any
    ) -> torch.Tensor: ...

    def predict_noise(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        **kwargs: Any,
    ) -> torch.Tensor:
        """CFG-combined noise prediction for one step."""
        if self.classifier_free_guidance:
            assert clip_text_embedding.shape[0] % 2 == 0, f"invalid batch size: {clip_text_embedding.shape[0]}"

        timestep = self.solver.timesteps[step][None]
        self.set_unet_context(timestep=timestep, clip_text_embedding=clip_text_embedding, **kwargs)

        latents = torch.cat((x, x)) if self.classifier_free_guidance else x
        latents = self.solver.scale_model_input(latents, step=step)
        if not self.classifier_free_guidance:
            return self.unet(latents)
        unconditional_prediction, conditional_prediction = self.unet(latents).chunk(2)
        predicted_noise = unconditional_prediction + condition_scale * (conditional_prediction - unconditional_prediction)
        if self.has_self_attention_guidance():
            predicted_noise = predicted_noise + self.compute_self_attention_guidance(
                x=x[:, :4], noise=unconditional_prediction, step=step, clip_text_embedding=clip_text_embedding, **kwargs
            )
        return predicted_noise

    def forward(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        """One denoising step; a stochastic solver draws from `generator`."""
        predicted_noise = self.predict_noise(
            x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
        )
        # keep only the 4 latent channels (inpainting concatenates more)
        return self.solver(x[:, :4], predicted_noise=predicted_noise, step=step, generator=generator)

    def diffuse(
        self,
        x: torch.Tensor,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        """The whole denoising loop over the solver's inference steps; a
        stochastic solver draws from `generator` at each step."""
        state = self.solver.init_state()
        if isinstance(state, torch.Tensor):  # multistep solvers carry a latent-shaped estimate
            state = state.to(device=x.device, dtype=torch.float32).expand(x[:, :4].shape)
        for step in self.steps:
            noise = self.predict_noise(
                x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
            )
            latents4, state = self.solver.step(x[:, :4], noise, step, state, generator=generator)
            x = torch.cat([latents4, x[:, 4:]], dim=1) if x.shape[1] > 4 else latents4
        return x[:, :4]

    def structural_copy(self: TLatentDiffusionModel) -> TLatentDiffusionModel:
        """A copy with its own chains (and contexts) around the same weights, on the same device."""
        return self.__class__(
            unet=self.unet.structural_copy(),
            lda=self.lda.structural_copy(),
            clip_text_encoder=self.clip_text_encoder.structural_copy(),
            solver=self.solver,
            device=self.unet.device,
        )
