"""DDPM solver (arXiv:2006.11239); counterpart of
``refiners_tpu/foundationals/latent_diffusion/solvers/ddpm.py``. It only
provides the noise schedule for training (`add_noise`), with leading
timestep spacing; calling it raises, as in the JAX package.
"""

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


class DDPM(Solver):
    """Only used for training latent diffusion models; cannot be called."""

    default_params = dataclasses.replace(Solver.default_params, timesteps_spacing=TimestepSpacing.LEADING)

    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        device: Any = None,
    ) -> None:
        if params and params.model_prediction_type not in (ModelPredictionType.NOISE, None):
            raise NotImplementedError
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            params=params,
            device=device,
        )

    def __call__(self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int) -> torch.Tensor:
        raise NotImplementedError
