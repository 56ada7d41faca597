"""LatentDiffusionModel base; counterpart of
``refiners_tpu/foundationals/latent_diffusion/model.py``.

Owns the unet, the VAE (`lda`), the text encoder and the solver. `forward` is
one denoising step (context set → CFG batch → unet → guidance → solver
update); `diffuse` is the whole loop, a Python loop over the steps that
carries (latents, solver state) where the JAX package runs a `lax.scan`.
Latents are NCHW.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import Solver


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
        return unconditional_prediction + condition_scale * (conditional_prediction - unconditional_prediction)

    def forward(
        self,
        x: torch.Tensor,
        step: int,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        **kwargs: Any,
    ) -> torch.Tensor:
        """One denoising step."""
        predicted_noise = self.predict_noise(
            x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
        )
        # keep only the 4 latent channels (inpainting concatenates more)
        return self.solver(x[:, :4], predicted_noise=predicted_noise, step=step)

    def diffuse(
        self,
        x: torch.Tensor,
        *,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        **kwargs: Any,
    ) -> torch.Tensor:
        """The whole denoising loop over the solver's inference steps."""
        state = self.solver.init_state()
        for step in self.steps:
            noise = self.predict_noise(
                x, step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
            )
            latents4, state = self.solver.step(x[:, :4], noise, step, state)
            x = torch.cat([latents4, x[:, 4:]], dim=1) if x.shape[1] > 4 else latents4
        return x[:, :4]
