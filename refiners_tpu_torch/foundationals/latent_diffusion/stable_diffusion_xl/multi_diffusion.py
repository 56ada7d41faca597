"""SDXL MultiDiffusion; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/multi_diffusion.py``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import DiffusionTarget, MultiDiffusion
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import StableDiffusion_XL


@dataclass(kw_only=True)
class SDXLTarget(DiffusionTarget):
    clip_text_embedding: torch.Tensor
    condition_scale: float = 5.0
    pooled_text_embedding: torch.Tensor = None  # type: ignore[assignment]
    time_ids: torch.Tensor = None  # type: ignore[assignment]


class SDXLMultiDiffusion(MultiDiffusion[SDXLTarget]):
    def __init__(self, sd: StableDiffusion_XL) -> None:
        self.sd = sd

    def diffuse_target(self, x: torch.Tensor, step: int, target: SDXLTarget) -> torch.Tensor:
        """One step of `sd` on the crop, through the target's own solver."""
        old_solver = self.sd.solver
        self.sd.solver = target.solver
        result = self.sd(
            x,
            step,
            clip_text_embedding=target.clip_text_embedding,
            pooled_text_embedding=target.pooled_text_embedding,
            time_ids=target.time_ids,
            condition_scale=target.condition_scale,
        )
        self.sd.solver = old_solver
        return result
