"""Euler solver (arXiv:2206.00364); counterpart of
``refiners_tpu/foundationals/latent_diffusion/solvers/euler.py``."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    BaseSolverParams,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
)


class Euler(Solver):
    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        if params and params.noise_schedule not in (NoiseSchedule.QUADRATIC, None):
            raise NotImplementedError
        if params and params.sde_variance != 0.0:
            raise NotImplementedError("Euler does not support sde_variance != 0.0 yet")
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            params=params,
            device=device,
            dtype=dtype,
        )
        sigmas = torch.tensor(self._generate_sigmas(), dtype=torch.float32, device=device)
        self.register_buffer("sigmas", sigmas, persistent=False)

    @property
    def init_noise_sigma(self) -> torch.Tensor:
        return self.sigmas.max()

    def _generate_sigmas(self) -> np.ndarray:
        """The sigma table (from the float32 tables) interpolated at the timesteps, then 0."""
        tables = {k: v.astype(np.float32) for k, v in self._np_tables().items()}
        sigmas = tables["noise_std"] / tables["cumulative_scale_factors"]
        sigmas = np.interp(self._generate_timesteps().astype(np.float64), np.arange(0, len(sigmas)), sigmas)
        return np.concatenate([sigmas, [0.0]])

    def scale_model_input(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """× init_noise_sigma at step -1; ÷ √(σ² + 1) otherwise."""
        if step == -1:
            return x * self.init_noise_sigma.to(x.dtype)
        sigma = self.sigmas[step]
        return (x.float() / torch.sqrt(sigma**2 + 1)).to(x.dtype)

    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        self._check_step(step)
        xf = x.float()
        pf = predicted_noise.float()
        if self.params.model_prediction_type == ModelPredictionType.SAMPLE:
            ratio = self.sigmas[step + 1] / self.sigmas[step]  # the model predicts x0 directly
            return (ratio * xf + (1 - ratio) * pf).to(x.dtype)
        assert self.params.model_prediction_type == ModelPredictionType.NOISE
        return (xf + pf * (self.sigmas[step + 1] - self.sigmas[step])).to(x.dtype)
