"""Restart sampling (arXiv:2306.14878); counterpart of
``refiners_tpu/foundationals/latent_diffusion/restart.py``.

At `start_step` of a DDIM trajectory, the latents are noised forward from
the timestep where σ ≈ `start_time` to the one where σ ≈ `end_time`, then
denoised again over `num_steps` timesteps by a fresh DDIM whose timesteps
are overwritten; `num_iterations` times. The noise comes from a
`torch.Generator` (the JAX package folds the iteration into a PRNG key).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Generic, TypeVar

import numpy as np
import torch

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DDIM, Solver
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import gather

T = TypeVar("T", bound=LatentDiffusionModel)


def add_noise_interval(
    solver: Solver,
    /,
    x: torch.Tensor,
    noise: torch.Tensor,
    initial_timestep: torch.Tensor,
    target_timestep: torch.Tensor,
) -> torch.Tensor:
    """Noise `x` from `initial_timestep` forward to `target_timestep`."""
    initial = gather(solver.cumulative_scale_factors, initial_timestep)
    target = gather(solver.cumulative_scale_factors, target_timestep)
    factor = target / initial
    return factor * x + torch.sqrt(1 - factor**2) * noise


@dataclass
class Restart(Generic[T]):
    """Restart sampling for a model whose solver is DDIM."""

    ldm: T
    num_steps: int = 10
    num_iterations: int = 2
    start_time: float = 0.1
    end_time: float = 2
    _solvers: dict[tuple[int, torch.device], DDIM] = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        assert isinstance(self.ldm.solver, DDIM), "Restart sampling only works with DDIM solver"

    def __call__(
        self,
        x: torch.Tensor,
        /,
        clip_text_embedding: torch.Tensor,
        condition_scale: float = 7.5,
        generator: torch.Generator | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        original_solver = self.ldm.solver
        new_solver = self._solver(original_solver.num_inference_steps, original_solver.timesteps.device)
        self.ldm.solver = new_solver
        try:
            for i in range(self.num_iterations):
                noise = self._restart_noise(generator, tuple(x.shape), x.device, i).to(x.dtype)
                x = add_noise_interval(
                    new_solver,
                    x=x,
                    noise=noise,
                    initial_timestep=new_solver.timesteps[-1],
                    target_timestep=new_solver.timesteps[0],
                )
                for step in range(len(self.timesteps) - 1):
                    x = self.ldm(
                        x, step=step, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, **kwargs
                    )
        finally:
            self.ldm.solver = original_solver
        return x

    def _solver(self, num_inference_steps: int, device: torch.device) -> DDIM:
        """The restart DDIM (its timesteps overwritten), built once for a
        step count and device: its tables go up to the device at the first
        call, not inside a compiled program's capture."""
        key = (num_inference_steps, device)
        if key not in self._solvers:
            solver = DDIM(num_inference_steps, device=device)
            solver.timesteps = self.timesteps.to(device)
            self._solvers[key] = solver
        return self._solvers[key]

    def _restart_noise(
        self, generator: torch.Generator | None, shape: tuple[int, ...], device: torch.device, iteration: int
    ) -> torch.Tensor:
        """Standard normal float32 noise of iteration `iteration`, drawn from
        `generator` (else the device's seeded generator). A method of its own
        so that tests can inject another noise sequence."""
        generator = generator if generator is not None else rng.generator(device)
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    @cached_property
    def start_step(self) -> int:
        """The step of the trajectory whose σ is closest to `start_time`."""
        solver = self.ldm.solver
        sigmas = solver.noise_std / solver.cumulative_scale_factors
        return int(torch.argmin(torch.abs(sigmas[solver.timesteps.long()] - self.start_time)))

    @cached_property
    def end_timestep(self) -> int:
        """The timestep whose σ is closest to `end_time`."""
        solver = self.ldm.solver
        sigmas = solver.noise_std / solver.cumulative_scale_factors
        return int(torch.argmin(torch.abs(sigmas - self.end_time)))

    @cached_property
    def timesteps(self) -> torch.Tensor:
        """`num_steps` timesteps from `end_timestep` down to the start step's, as int64 on the CPU."""
        start = int(self.ldm.solver.timesteps[self.start_step])
        ts = np.round(np.linspace(start, self.end_timestep, self.num_steps))[::-1].astype(np.int64)
        return torch.from_numpy(ts.copy())
