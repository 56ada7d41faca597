"""DDIM solver (arXiv:2010.02502); counterpart of
``refiners_tpu/foundationals/latent_diffusion/solvers/ddim.py``."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    BaseSolverParams,
    ModelPredictionType,
    Solver,
    TimestepSpacing,
)


class DDIM(Solver):
    default_params = dataclasses.replace(
        Solver.default_params,
        timesteps_spacing=TimestepSpacing.LEADING,
        timesteps_offset=1,
    )

    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        if params and params.model_prediction_type not in (ModelPredictionType.NOISE, None):
            raise NotImplementedError
        if params and params.sde_variance != 0.0:
            raise NotImplementedError("DDIM does not support sde_variance != 0.0 yet")
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            params=params,
            device=device,
            dtype=dtype,
        )

    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Deterministic DDIM update, in float32; no noise on the last step."""
        self._check_step(step)
        is_last = step == self.num_inference_steps - 1
        current_scale = self.cumulative_scale_factors[self.timesteps[step].long()]
        xf = x.float()
        nf = predicted_noise.float()
        predicted_x = (xf - torch.sqrt(1 - current_scale**2) * nf) / current_scale
        if is_last:
            previous_scale = self.cumulative_scale_factors[0]
            return (previous_scale * predicted_x).to(x.dtype)
        previous_scale = self.cumulative_scale_factors[self.timesteps[step + 1].long()]
        return (previous_scale * predicted_x + torch.sqrt(1 - previous_scale**2) * nf).to(x.dtype)
