"""SD1.5 MultiDiffusion; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/multi_diffusion.py``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import DiffusionTarget, MultiDiffusion
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import StableDiffusion_1


@dataclass(kw_only=True)
class SD1DiffusionTarget(DiffusionTarget):
    clip_text_embedding: torch.Tensor
    condition_scale: float = 7.0


class SD1MultiDiffusion(MultiDiffusion[SD1DiffusionTarget]):
    def __init__(self, sd: StableDiffusion_1) -> None:
        self.sd = sd

    def diffuse_target(self, x: torch.Tensor, step: int, target: SD1DiffusionTarget) -> torch.Tensor:
        """One step of `sd` on the crop, through the target's own solver."""
        old_solver = self.sd.solver
        self.sd.solver = target.solver
        result = self.sd(
            x,
            step,
            clip_text_embedding=target.clip_text_embedding,
            condition_scale=target.condition_scale,
        )
        self.sd.solver = old_solver
        return result
