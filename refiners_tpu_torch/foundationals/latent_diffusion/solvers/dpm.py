"""DPM-Solver++ (2M) (arXiv:2211.01095), deterministic and SDE variants;
counterpart of ``refiners_tpu/foundationals/latent_diffusion/solvers/dpm.py``.

The constants are computed in float64 numpy on the host, as in the JAX
package (the original DPM codebase's linspace semantics), then kept as
float32 tables indexed by *inference step*. The multistep state (the
previous data estimate) is carried by `step`/`init_state` in `diffuse`;
the stateful `__call__` keeps the last estimate in a deque for
step-by-step use.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    BaseSolverParams,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    TimestepSpacing,
)


def _np_safe_log(x: np.ndarray, lower_bound: float = 1e-6) -> np.ndarray:
    return np.log(np.maximum(x, lower_bound))


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0))


class DPMSolver(Solver):
    default_params = dataclasses.replace(Solver.default_params, timesteps_spacing=TimestepSpacing.CUSTOM)

    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        last_step_first_order: bool = False,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        if params and params.model_prediction_type not in (ModelPredictionType.NOISE, None):
            raise NotImplementedError
        if params and params.sde_variance not in (0.0, 1.0):
            raise NotImplementedError("DPMSolver only supports sde_variance=0.0 or 1.0")
        super().__init__(
            num_inference_steps=num_inference_steps,
            first_inference_step=first_inference_step,
            params=params,
            device=device,
            dtype=dtype,
        )
        self.last_step_first_order = last_step_first_order

        # float64 host math from float32-rounded base tables, as in the JAX package
        scale_factors = self._np_noise_schedule()
        cumprod32 = np.cumprod(scale_factors, dtype=np.float32)
        cumulative = np.sqrt(cumprod32, dtype=np.float32).astype(np.float64)
        noise_std = np.sqrt(1.0 - cumprod32, dtype=np.float32).astype(np.float64)
        sigmas = noise_std / cumulative
        np_timesteps = self._generate_timesteps().astype(np.float64)
        rescaled = self._np_rescale_sigmas(sigmas, self.params.sigma_schedule, np_timesteps)
        sigma_min = sigmas[0:1]  # diffusers' final_sigmas_type="sigma_min"
        full_sigmas = np.concatenate([rescaled, sigma_min])
        cum = 1.0 / np.sqrt(full_sigmas**2 + 1.0)
        std = full_sigmas * cum
        tables = {
            "sigmas": full_sigmas,
            "cumulative_scale_factors": cum,
            "noise_std": std,
            "signal_to_noise_ratios": _np_safe_log(cum) - _np_safe_log(std),
        }
        for name, table in tables.items():
            self.register_buffer(name, torch.tensor(table, dtype=torch.float32, device=device), persistent=False)
        timesteps = self._np_timesteps_from_sigmas(sigmas, full_sigmas)
        self.register_buffer("timesteps", torch.from_numpy(timesteps).to(device), persistent=False)
        self.estimated_data: deque[torch.Tensor] = deque([self.init_state()] * 2, maxlen=2)

    def rebuild(self, num_inference_steps: int | None, first_inference_step: int | None = None) -> "DPMSolver":
        r = super().rebuild(num_inference_steps, first_inference_step)
        r.last_step_first_order = self.last_step_first_order
        return r

    def _generate_timesteps(self) -> np.ndarray:
        if self.params.timesteps_spacing != TimestepSpacing.CUSTOM:
            return super()._generate_timesteps()
        # numpy linspace semantics matter: np.linspace(0, 999, 31)[15] is
        # 499.49999999999994, as in the original DPM codebase
        offset = self.params.timesteps_offset
        max_timestep = self.params.num_train_timesteps - 1 + offset
        np_space = np.linspace(offset, max_timestep, self.num_inference_steps + 1).round().astype(np.int32)[1:]
        return np_space[::-1].copy()

    def _np_rescale_sigmas(
        self, sigmas: np.ndarray, sigma_schedule: NoiseSchedule | None, timesteps: np.ndarray
    ) -> np.ndarray:
        """Sigmas at the timesteps, or rescaled per schedule (Karras: ρ = 7)."""
        match sigma_schedule:
            case NoiseSchedule.UNIFORM:
                rho = 1
            case NoiseSchedule.QUADRATIC:
                rho = 2
            case NoiseSchedule.KARRAS:
                rho = 7
            case None:
                return np.interp(timesteps, np.arange(0, len(sigmas)), sigmas)
        linear = np.linspace(0, 1, self.num_inference_steps)
        first, last = sigmas[0], sigmas[-1]
        rescaled = (first ** (1 / rho) + linear * (last ** (1 / rho) - first ** (1 / rho))) ** rho
        return rescaled[::-1].copy()

    def _np_timesteps_from_sigmas(self, train_sigmas: np.ndarray, step_sigmas: np.ndarray) -> np.ndarray:
        """Map the step sigmas back to (interpolated, rounded) train timesteps."""
        log_train = _np_safe_log(train_sigmas)
        out = []
        for sigma in step_sigmas[:-1]:
            log_sigma = _np_safe_log(np.asarray(sigma))
            dist = log_sigma - log_train[:, None]
            low_idx = int(np.argmax(np.cumsum((dist >= 0), axis=0), axis=0).clip(max=len(train_sigmas) - 2)[0])
            high_idx = low_idx + 1
            low, high = log_train[low_idx], log_train[high_idx]
            w = np.clip((low - log_sigma) / (low - high), 0, 1)
            out.append(((1 - w) * low_idx + w * high_idx).item())
        return np.asarray(out).round().astype(np.int32)

    # noise helpers indexed by inference step
    def _add_noise(self, x: torch.Tensor, noise: torch.Tensor, step: int) -> torch.Tensor:
        csf = self.cumulative_scale_factors[step]
        std = self.noise_std[step]
        return (csf * x.float() + std * noise.float()).to(x.dtype)

    def remove_noise(self, x: torch.Tensor, noise: torch.Tensor, step: int) -> torch.Tensor:
        csf = self.cumulative_scale_factors[step]
        std = self.noise_std[step]
        return ((x.float() - std * noise.float()) / csf).to(x.dtype)

    # -- updates ------------------------------------------------------------

    def _first_order_update(
        self, x: torch.Tensor, estimate: torch.Tensor, step: int, sde_noise: torch.Tensor | None
    ) -> torch.Tensor:
        current_ratio = self.signal_to_noise_ratios[step]
        next_ratio = self.signal_to_noise_ratios[step + 1]
        next_scale = self.cumulative_scale_factors[step + 1]
        next_std = self.noise_std[step + 1]
        current_std = self.noise_std[step]
        ratio_delta = current_ratio - next_ratio

        if sde_noise is None:
            return (next_std / current_std) * x + (1.0 - torch.exp(ratio_delta)) * next_scale * estimate
        factor = 1.0 - torch.exp(2.0 * ratio_delta)
        return (
            (next_std / current_std) * torch.exp(ratio_delta) * x
            + next_scale * factor * estimate
            + next_std * _safe_sqrt(factor) * sde_noise
        )

    def _second_order_update(
        self,
        x: torch.Tensor,
        estimate: torch.Tensor,
        prev_estimate: torch.Tensor,
        step: int,
        sde_noise: torch.Tensor | None,
    ) -> torch.Tensor:
        next_ratio = self.signal_to_noise_ratios[step + 1]
        current_ratio = self.signal_to_noise_ratios[step]
        previous_ratio = self.signal_to_noise_ratios[max(step - 1, 0)]
        next_scale = self.cumulative_scale_factors[step + 1]
        next_std = self.noise_std[step + 1]
        current_std = self.noise_std[step]

        estimation_delta = (estimate - prev_estimate) / (
            (current_ratio - previous_ratio) / (next_ratio - current_ratio)
        )
        ratio_delta = current_ratio - next_ratio

        if sde_noise is None:
            factor = 1.0 - torch.exp(ratio_delta)
            return (
                (next_std / current_std) * x
                + next_scale * factor * estimate
                + 0.5 * next_scale * factor * estimation_delta
            )
        factor = 1.0 - torch.exp(2.0 * ratio_delta)
        return (
            (next_std / current_std) * torch.exp(ratio_delta) * x
            + next_scale * factor * estimate
            + 0.5 * next_scale * factor * estimation_delta
            + next_std * _safe_sqrt(factor) * sde_noise
        )

    def _update(
        self,
        x: torch.Tensor,
        predicted_noise: torch.Tensor,
        step: int,
        prev_estimate: torch.Tensor,
        generator: torch.Generator | None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        xf = x.float()
        nf = predicted_noise.float()
        estimate = (xf - self.noise_std[step] * nf) / self.cumulative_scale_factors[step]

        sde_noise = None
        if self.params.sde_variance > 0.0:
            sde_noise = self._sde_noise(generator, tuple(x.shape)) * self.params.sde_variance

        if step == self.first_inference_step or (self.last_step_first_order and step == self.num_inference_steps - 1):
            out = self._first_order_update(xf, estimate, step, sde_noise)
        else:
            out = self._second_order_update(xf, estimate, prev_estimate, step, sde_noise)
        return out.to(x.dtype), estimate

    def _sde_noise(self, generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
        """The SDE variant's noise, one draw per step. A method of its own so
        that trajectory tests can inject another noise sequence."""
        return self._randn(generator, shape)

    def init_state(self) -> torch.Tensor:
        """A placeholder previous estimate, broadcast to the latents on the first step."""
        return torch.zeros((), device=self.timesteps.device)

    def step(
        self,
        x: torch.Tensor,
        predicted_noise: torch.Tensor,
        step: int,
        state: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        prev_estimate = state.to(device=x.device, dtype=torch.float32).expand(x.shape)
        return self._update(x, predicted_noise, step, prev_estimate, generator)

    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        self._check_step(step)
        out, estimate = self.step(x, predicted_noise, step, self.estimated_data[-1], generator)
        self.estimated_data.append(estimate)
        return out
