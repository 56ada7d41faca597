"""FrankenSolver: an external (diffusers-like) scheduler behind the Solver
API; counterpart of ``refiners_tpu/foundationals/latent_diffusion/solvers/franken.py``.

The scheduler takes and returns torch tensors, as the port's latents are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

import numpy as np
import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import Solver, TimestepSpacing


class SchedulerOutputLike(Protocol):
    @property
    def prev_sample(self) -> torch.Tensor: ...


class SchedulerLike(Protocol):
    timesteps: torch.Tensor

    @property
    def init_noise_sigma(self) -> torch.Tensor: ...

    def set_timesteps(self, num_inference_steps: int, *args: Any, **kwargs: Any) -> None: ...

    def scale_model_input(self, sample: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor: ...

    def step(
        self, model_output: torch.Tensor, timestep: torch.Tensor, sample: torch.Tensor, *args: Any, **kwargs: Any
    ) -> SchedulerOutputLike | tuple[Any]: ...


class FrankenSolver(Solver):
    default_params = dataclasses.replace(Solver.default_params, timesteps_spacing=TimestepSpacing.CUSTOM)

    def __init__(
        self,
        get_diffusers_scheduler: Callable[[], SchedulerLike],
        num_inference_steps: int,
        first_inference_step: int = 0,
        device: Any = None,
        dtype: Any = None,
        **kwargs: Any,
    ) -> None:
        self.get_diffusers_scheduler = get_diffusers_scheduler
        self.diffusers_scheduler = get_diffusers_scheduler()
        self.diffusers_scheduler.set_timesteps(num_inference_steps)
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            device=device,
        )

    def _generate_timesteps(self) -> np.ndarray:
        return np.asarray(self.diffusers_scheduler.timesteps)

    def rebuild(self, num_inference_steps: int | None, first_inference_step: int | None = None) -> "FrankenSolver":
        return self.__class__(
            get_diffusers_scheduler=self.get_diffusers_scheduler,
            num_inference_steps=self.num_inference_steps if num_inference_steps is None else num_inference_steps,
            first_inference_step=self.first_inference_step if first_inference_step is None else first_inference_step,
            device=self.timesteps.device,
        )

    def scale_model_input(self, x: torch.Tensor, step: int) -> torch.Tensor:
        if step == -1:
            return x * float(self.diffusers_scheduler.init_noise_sigma)
        return self.diffusers_scheduler.scale_model_input(x, self.timesteps[step]).to(x.dtype)

    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        r = self.diffusers_scheduler.step(predicted_noise, self.timesteps[step], x)
        assert not isinstance(r, tuple), "scheduler returned a tuple"
        return r.prev_sample.to(x.dtype)
