"""Latent Consistency Model solver (arXiv:2310.04378); counterpart of
``refiners_tpu/foundationals/latent_diffusion/solvers/lcm.py``.

Runs a subsampled DPM trajectory ("skipping-steps" distillation) and
re-noises between consistency steps, from an explicit generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.dpm import DPMSolver
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    BaseSolverParams,
    ModelPredictionType,
    Solver,
    SolverParams,
    TimestepSpacing,
    gather,
)


class LCMSolver(Solver):
    # the spacing applies to the underlying DPM solver
    default_params = dataclasses.replace(Solver.default_params, timesteps_spacing=TimestepSpacing.TRAILING)

    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        num_orig_steps: int = 50,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        assert (
            num_orig_steps >= num_inference_steps
        ), f"num_orig_steps ({num_orig_steps}) < num_inference_steps ({num_inference_steps})"

        params = self.resolve_params(params)
        if params.model_prediction_type != ModelPredictionType.NOISE:
            raise NotImplementedError
        self.num_orig_steps = num_orig_steps
        # in a list, not a submodule: `_generate_timesteps` reads its timesteps
        # on the host before Module.__init__; moved to `device` after
        self._dpm = [
            DPMSolver(
                num_inference_steps=num_orig_steps,
                params=SolverParams(
                    num_train_timesteps=params.num_train_timesteps,
                    timesteps_spacing=params.timesteps_spacing,
                ),
            )
        ]
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            params=params,
            device=device,
            dtype=dtype,
        )
        self.dpm.to(device=device)

    @property
    def dpm(self) -> DPMSolver:
        return self._dpm[0]

    def _apply(self, fn: Callable[[torch.Tensor], torch.Tensor], recurse: bool = True) -> "LCMSolver":
        self.dpm._apply(fn, recurse)  # `.to(device)` moves the DPM tables too
        return super()._apply(fn, recurse)

    def rebuild(self, num_inference_steps: int | None, first_inference_step: int | None = None) -> "LCMSolver":
        return self.__class__(
            num_inference_steps=self.num_inference_steps if num_inference_steps is None else num_inference_steps,
            first_inference_step=self.first_inference_step if first_inference_step is None else first_inference_step,
            params=dataclasses.replace(self.params),
            num_orig_steps=self.num_orig_steps,
            device=self.timesteps.device,
        )

    def _generate_timesteps(self) -> np.ndarray:
        # skipping-steps subsampling of the DPM trajectory
        indices = np.floor(np.linspace(0, self.dpm.num_inference_steps, self.num_inference_steps + 1)[:-1]).astype(int)
        self.timestep_indices: list[int] = indices.tolist()
        return self.dpm.timesteps.numpy()[indices]

    def _renoising_noise(self, generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
        """The noise added back between steps. A method of its own so that
        trajectory tests can inject another noise sequence."""
        return self._randn(generator, shape)

    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Consistency update with c_skip and c_out (σ = 0.5, t × 10), then
        re-noise to the next step's timestep through the DPM tables."""
        xf = x.float()
        nf = predicted_noise.float()

        current_timestep = self.timesteps[step].long()
        scale = gather(self.cumulative_scale_factors, current_timestep)
        std = gather(self.noise_std, current_timestep)
        estimate = (xf - std * nf) / scale

        # "Parameterization for Consistency Models"
        sigma = 0.5
        t = current_timestep.float() * 10
        c_skip = sigma**2 / (t**2 + sigma**2)
        c_out = t / torch.sqrt(sigma**2 + t**2)
        denoised = c_skip * xf + c_out * estimate

        if step == self.num_inference_steps - 1:
            return denoised.to(x.dtype)
        noise = self._renoising_noise(generator, tuple(x.shape))
        return self.dpm.add_noise(denoised, noise, self.timestep_indices[step + 1]).to(x.dtype)
