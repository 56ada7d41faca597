"""Diffusion solver base; counterpart of
``refiners_tpu/foundationals/latent_diffusion/solvers/solver.py``.

The schedules are computed on the host in numpy, exactly as in the JAX
package, and kept as float32 buffers (not part of the state dict) that move
with the solver: ``.to(device)`` puts them on the latents' device, so a step
gathers its coefficients there with no host round trip. Steps are Python
ints: the denoising loop is a Python loop. Stochastic solvers draw their
noise from an explicit ``torch.Generator`` on the latents' device, the
counterpart of the JAX package's PRNG ``key``.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, TypeVar

import numpy as np
import torch

from refiners_tpu_torch.fluxion import layers as fl

T = TypeVar("T", bound="Solver")


class NoiseSchedule(str, Enum):
    UNIFORM = "uniform"
    QUADRATIC = "quadratic"  # "Stable Diffusion" schedule, arXiv:2305.08891 table 1
    KARRAS = "karras"  # arXiv:2206.00364 eq. 5


class TimestepSpacing(str, Enum):
    """Timestep spacing kinds, arXiv:2305.08891 table 2."""

    LINSPACE = "linspace"
    LINSPACE_ROUNDED = "linspace_rounded"
    LEADING = "leading"
    TRAILING = "trailing"
    CUSTOM = "custom"


class ModelPredictionType(str, Enum):
    NOISE = "noise"
    SAMPLE = "sample"


@dataclasses.dataclass(kw_only=True, frozen=True)
class BaseSolverParams:
    num_train_timesteps: int | None
    timesteps_spacing: TimestepSpacing | None
    timesteps_offset: int | None
    initial_diffusion_rate: float | None
    final_diffusion_rate: float | None
    noise_schedule: NoiseSchedule | None
    sigma_schedule: NoiseSchedule | None
    model_prediction_type: ModelPredictionType | None
    sde_variance: float


@dataclasses.dataclass(kw_only=True, frozen=True)
class SolverParams(BaseSolverParams):
    """User-facing partial parameters."""

    num_train_timesteps: int | None = None
    timesteps_spacing: TimestepSpacing | None = None
    timesteps_offset: int | None = None
    initial_diffusion_rate: float | None = None
    final_diffusion_rate: float | None = None
    noise_schedule: NoiseSchedule | None = None
    sigma_schedule: NoiseSchedule | None = None
    model_prediction_type: ModelPredictionType | None = None
    sde_variance: float = 0.0


@dataclasses.dataclass(kw_only=True, frozen=True)
class ResolvedSolverParams(BaseSolverParams):
    num_train_timesteps: int
    timesteps_spacing: TimestepSpacing
    timesteps_offset: int
    initial_diffusion_rate: float
    final_diffusion_rate: float
    noise_schedule: NoiseSchedule
    sigma_schedule: NoiseSchedule | None
    model_prediction_type: ModelPredictionType
    sde_variance: float


class Solver(fl.Module, ABC):
    """Base diffusion solver; precomputes the schedule tables."""

    timesteps: torch.Tensor
    cumulative_scale_factors: torch.Tensor
    noise_std: torch.Tensor
    params: ResolvedSolverParams

    default_params = ResolvedSolverParams(
        num_train_timesteps=1000,
        timesteps_spacing=TimestepSpacing.LINSPACE,
        timesteps_offset=0,
        initial_diffusion_rate=8.5e-4,
        final_diffusion_rate=1.2e-2,
        noise_schedule=NoiseSchedule.QUADRATIC,
        sigma_schedule=None,
        model_prediction_type=ModelPredictionType.NOISE,
        sde_variance=0.0,
    )

    def __init__(
        self,
        num_inference_steps: int,
        first_inference_step: int = 0,
        params: BaseSolverParams | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__()
        self.num_inference_steps = num_inference_steps
        self.first_inference_step = first_inference_step
        self.params = self.resolve_params(params)

        for name, table in self._np_tables().items():
            self.register_buffer(name, torch.tensor(table, dtype=torch.float32, device=device), persistent=False)
        timesteps = self._generate_timesteps()
        self.register_buffer("timesteps", torch.from_numpy(timesteps.copy()).to(device), persistent=False)

    # -- schedule construction (host, numpy) --------------------------------

    def resolve_params(self, params: BaseSolverParams | None) -> ResolvedSolverParams:
        if params is None:
            return dataclasses.replace(self.default_params)
        return dataclasses.replace(
            self.default_params,
            **{k: v for k, v in dataclasses.asdict(params).items() if v is not None},
        )

    def _np_tables(self) -> dict[str, np.ndarray]:
        """The schedule's tables on the host, indexed by train timestep."""
        scale_factors = self._np_noise_schedule()
        cumulative = np.sqrt(np.cumprod(scale_factors))
        noise_std = np.sqrt(1.0 - np.cumprod(scale_factors))
        return {
            "scale_factors": scale_factors,
            "cumulative_scale_factors": cumulative,
            "noise_std": noise_std,
            "signal_to_noise_ratios": np.log(cumulative) - np.log(noise_std),
        }

    def _np_power_distribution(self, power: float) -> np.ndarray:
        """linspace between the diffusion rates in power space; float32 as in
        the JAX package, so that the tables match it bit for bit."""
        return (
            np.linspace(
                np.float32(self.params.initial_diffusion_rate) ** np.float32(1 / power),
                np.float32(self.params.final_diffusion_rate) ** np.float32(1 / power),
                self.params.num_train_timesteps,
                dtype=np.float32,
            )
            ** np.float32(power)
        )

    def _np_noise_schedule(self) -> np.ndarray:
        """The 1 - beta_t table."""
        match self.params.noise_schedule:
            case NoiseSchedule.UNIFORM:
                return 1.0 - self._np_power_distribution(1)
            case NoiseSchedule.QUADRATIC:
                return 1.0 - self._np_power_distribution(2)
            case NoiseSchedule.KARRAS:
                return 1.0 - self._np_power_distribution(7)

    @staticmethod
    def generate_timesteps(
        spacing: TimestepSpacing,
        num_inference_steps: int,
        num_train_timesteps: int = 1000,
        offset: int = 0,
    ) -> np.ndarray:
        """Timesteps (descending) for a given spacing."""
        max_timestep = num_train_timesteps - 1 + offset
        match spacing:
            case TimestepSpacing.LINSPACE:
                return np.linspace(offset, max_timestep, num_inference_steps, dtype=np.float64)[::-1].astype(
                    np.float32
                )
            case TimestepSpacing.LINSPACE_ROUNDED:
                return np.linspace(offset, max_timestep, num_inference_steps).round().astype(np.int32)[::-1]
            case TimestepSpacing.LEADING:
                step_ratio = num_train_timesteps // num_inference_steps
                return (np.arange(0, num_inference_steps, 1) * step_ratio + offset).astype(np.int32)[::-1]
            case TimestepSpacing.TRAILING:
                step_ratio = num_train_timesteps // num_inference_steps
                return np.arange(max_timestep, offset, -step_ratio).astype(np.int32)
            case TimestepSpacing.CUSTOM:
                raise RuntimeError("generate_timesteps called with custom spacing")

    def _generate_timesteps(self) -> np.ndarray:
        return self.generate_timesteps(
            spacing=self.params.timesteps_spacing,
            num_inference_steps=self.num_inference_steps,
            num_train_timesteps=self.params.num_train_timesteps,
            offset=self.params.timesteps_offset,
        )

    # -- runtime API ---------------------------------------------------------

    @abstractmethod
    def __call__(
        self, x: torch.Tensor, predicted_noise: torch.Tensor, step: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Apply one denoising step; stochastic solvers draw from `generator`."""
        ...

    def init_state(self) -> Any:
        """Loop-carried state of multistep solvers; () when stateless."""
        return ()

    def step(
        self,
        x: torch.Tensor,
        predicted_noise: torch.Tensor,
        step: int,
        state: Any,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, Any]:
        """Functional step carrying the solver state; default: stateless __call__."""
        return self(x, predicted_noise, step, generator=generator), state

    def _randn(self, generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
        """Standard normal float32 noise on the tables' device, from an explicit generator."""
        if generator is None:
            raise ValueError(f"{type(self).__name__} draws noise: pass a torch.Generator")
        return torch.randn(shape, generator=generator, device=self.timesteps.device, dtype=torch.float32)

    def _check_step(self, step: int) -> None:
        assert self.first_inference_step <= step < self.num_inference_steps, f"invalid step {step}"

    def _add_noise(self, x: torch.Tensor, noise: torch.Tensor, step: int) -> torch.Tensor:
        timestep = self.timesteps[step].long()  # indexed on the tables' device, no host read
        csf = self.cumulative_scale_factors[timestep]
        std = self.noise_std[timestep]
        # arXiv:2006.11239 Eq. 4, in float32
        return (csf * x.float() + std * noise.float()).to(x.dtype)

    def add_noise(self, x: torch.Tensor, noise: torch.Tensor, step: int | list[int]) -> torch.Tensor:
        """Noise `x` to the timestep of inference step `step`; with a list,
        one step per batch element."""
        if isinstance(step, list):
            assert len(x) == len(noise) == len(step)
            return torch.stack([self._add_noise(x[i], noise[i], s) for i, s in enumerate(step)], dim=0)
        return self._add_noise(x, noise, step)

    def remove_noise(self, x: torch.Tensor, noise: torch.Tensor, step: int) -> torch.Tensor:
        """The inverse of `add_noise`, arXiv:2006.11239 Eq. 15, in float32."""
        timestep = self.timesteps[step].long()
        csf = self.cumulative_scale_factors[timestep]
        std = self.noise_std[timestep]
        return ((x.float() - std * noise.float()) / csf).to(x.dtype)

    @property
    def all_steps(self) -> list[int]:
        return list(range(self.num_inference_steps))

    @property
    def inference_steps(self) -> list[int]:
        return self.all_steps[self.first_inference_step :]

    def rebuild(self: T, num_inference_steps: int | None, first_inference_step: int | None = None) -> T:
        """A new instance with an updated step configuration, on this device."""
        return self.__class__(
            num_inference_steps=self.num_inference_steps if num_inference_steps is None else num_inference_steps,
            first_inference_step=self.first_inference_step if first_inference_step is None else first_inference_step,
            params=dataclasses.replace(self.params),
            device=self.timesteps.device,
        )

    def scale_model_input(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Identity by default."""
        return x
