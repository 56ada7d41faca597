"""The port's solvers against the JAX package's, on the CPU.

Both sides take the same numpy latents and noise predictions (fixed per
step, independent of the trajectory); the noise a stochastic solver draws
(DPM-SDE, LCM's re-noising) is drawn on the JAX side from its PRNG key and
handed to the port through the method that draws it. The latents are
(1, 4, 8, 8) on both sides: a solver is elementwise, so the layout is moot.
"""

from __future__ import annotations

import types
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refiners_tpu.foundationals.latent_diffusion import solvers as jax_solvers
from refiners_tpu_torch.foundationals.latent_diffusion import solvers

# float32 on both sides, the same formulas: rounding of a few elementwise operations per step
TOL = 1e-5
SHAPE = (1, 4, 8, 8)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _prediction(step: int) -> np.ndarray:
    return np.random.RandomState(100 + step).randn(*SHAPE).astype(np.float32)


def _jax_noise(step: int) -> np.ndarray:
    """The JAX solvers' own draw for `step`: `jax.random.normal(key, shape)`."""
    return np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(0), step), SHAPE, dtype=jnp.float32))


def _inject(port: Any, method: str) -> None:
    """Serve the port's draws from `_jax_noise`, one per step in order."""
    steps = iter(port.inference_steps)

    def draw(generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
        assert tuple(shape) == SHAPE
        return torch.tensor(_jax_noise(next(steps)))

    setattr(port, method, draw)


def _trajectories(jax_solver: Any, port: Any, scale_input: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Both solvers from the same start over their inference steps, each
    stochastic step keyed by `fold_in(key(0), step)` on the JAX side."""
    x0 = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    want, got = jnp.asarray(x0), torch.tensor(x0)
    if scale_input:
        want, got = jax_solver.scale_model_input(want, -1), port.scale_model_input(got, -1)
    for step in port.inference_steps:
        prediction = _prediction(step)
        key = jax.random.fold_in(jax.random.key(0), step)
        if scale_input:  # what the model sees; the update takes the unscaled latents
            np.testing.assert_allclose(
                port.scale_model_input(got, step).numpy(), np.asarray(jax_solver.scale_model_input(want, step)), rtol=TOL
            )
        want = jax_solver(want, jnp.asarray(prediction), step, key=key)
        got = port(got, torch.tensor(prediction), step, generator=torch.Generator())
    return got.numpy(), np.asarray(want)


def _assert_tables_equal(jax_solver: Any, port: Any, names: tuple[str, ...]) -> None:
    for name in names:
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(jax_solver, name)), err_msg=name)


DPM_CASES: dict[str, Callable[[Any], dict[str, Any]]] = {
    "2m": lambda s: {},
    "first_order_last_step": lambda s: {"last_step_first_order": True},
    "karras": lambda s: {"params": s.SolverParams(sigma_schedule=s.NoiseSchedule.KARRAS)},
    "sde": lambda s: {"params": s.SolverParams(sde_variance=1.0)},
    "img2img": lambda s: {"first_inference_step": 12},
}


@pytest.mark.parametrize("case", list(DPM_CASES))
def test_dpm_tables_and_trajectory_match_jax(case: str) -> None:
    jax_solver = jax_solvers.DPMSolver(num_inference_steps=30, **DPM_CASES[case](jax_solvers))
    port = solvers.DPMSolver(num_inference_steps=30, **DPM_CASES[case](solvers))
    _assert_tables_equal(
        jax_solver, port, ("timesteps", "sigmas", "cumulative_scale_factors", "noise_std", "signal_to_noise_ratios")
    )
    assert port.timesteps.dtype == torch.int32
    if case == "sde":
        _inject(port, "_sde_noise")
    got, want = _trajectories(jax_solver, port)
    assert _rel(got, want) <= TOL


def test_dpm_step_and_state_match_the_stateful_call() -> None:
    """`step` with the state `diffuse` carries (broadcast on the first step)
    equals the stateful `__call__`, as the JAX package's scan does."""
    stateful, functional = solvers.DPMSolver(num_inference_steps=10), solvers.DPMSolver(num_inference_steps=10)
    x = y = torch.tensor(np.random.RandomState(3).randn(*SHAPE).astype(np.float32))
    state = functional.init_state().expand(SHAPE)
    for step in stateful.inference_steps:
        x = stateful(x, 0.1 * torch.tanh(x), step)
        y, state = functional.step(y, 0.1 * torch.tanh(y), step, state)
    assert torch.equal(x, y)


def test_sde_draws_from_the_generator() -> None:
    """The SDE variant draws from the generator it is given, and raises without one."""
    port = solvers.DPMSolver(num_inference_steps=10, params=solvers.SolverParams(sde_variance=1.0))
    x, noise = torch.ones(SHAPE), torch.zeros(SHAPE)
    a = port.rebuild(10)(x, noise, 0, generator=torch.Generator().manual_seed(1))
    b = port.rebuild(10)(x, noise, 0, generator=torch.Generator().manual_seed(1))
    c = port.rebuild(10)(x, noise, 0, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        port.rebuild(10)(x, noise, 0)


@pytest.mark.parametrize("prediction_type", ["NOISE", "SAMPLE"])
def test_euler_tables_scaling_and_trajectory_match_jax(prediction_type: str) -> None:
    def params(s: Any) -> Any:
        return s.SolverParams(model_prediction_type=getattr(s.ModelPredictionType, prediction_type))

    jax_solver = jax_solvers.Euler(num_inference_steps=30, params=params(jax_solvers))
    port = solvers.Euler(num_inference_steps=30, params=params(solvers))
    _assert_tables_equal(jax_solver, port, ("timesteps", "sigmas"))
    assert float(port.init_noise_sigma) == float(jax_solver.init_noise_sigma)
    got, want = _trajectories(jax_solver, port, scale_input=True)
    assert _rel(got, want) <= TOL


def test_lcm_tables_and_trajectory_match_jax() -> None:
    jax_solver = jax_solvers.LCMSolver(num_inference_steps=4)
    port = solvers.LCMSolver(num_inference_steps=4)
    _assert_tables_equal(jax_solver, port, ("timesteps",))
    assert port.timestep_indices == jax_solver.timestep_indices
    _assert_tables_equal(jax_solver.dpm, port.dpm, ("timesteps", "cumulative_scale_factors", "noise_std"))
    _inject(port, "_renoising_noise")
    got, want = _trajectories(jax_solver, port)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", ["DDIM", "DPMSolver", "Euler"])
def test_add_and_remove_noise_match_jax(name: str) -> None:
    jax_solver, port = getattr(jax_solvers, name)(num_inference_steps=30), getattr(solvers, name)(num_inference_steps=30)
    rs = np.random.RandomState(4)
    x, noise = rs.randn(3, 4, 8, 8).astype(np.float32), rs.randn(3, 4, 8, 8).astype(np.float32)
    for step in (0, 14, 29):
        for method in ("add_noise", "remove_noise"):
            want = np.asarray(getattr(jax_solver, method)(jnp.asarray(x), jnp.asarray(noise), step))
            got = getattr(port, method)(torch.tensor(x), torch.tensor(noise), step).numpy()
            assert _rel(got, want) <= TOL, (method, step)
    want = np.asarray(jax_solver.add_noise(jnp.asarray(x), jnp.asarray(noise), [0, 14, 29]))
    assert _rel(port.add_noise(torch.tensor(x), torch.tensor(noise), [0, 14, 29]).numpy(), want) <= TOL
    # remove_noise undoes add_noise
    roundtrip = port.remove_noise(port.add_noise(torch.tensor(x), torch.tensor(noise), 14), torch.tensor(noise), 14)
    assert _rel(roundtrip.numpy(), x) <= TOL


class _EulerSchedulerShim:
    """A diffusers-like scheduler over the port's `Euler`: the external
    scheduler the FrankenSolver wraps (the JAX package's test wraps the
    reference's torch Euler the same way)."""

    def __init__(self) -> None:
        self.inner: solvers.Euler | None = None

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.inner = solvers.Euler(num_inference_steps=num_inference_steps)

    @property
    def timesteps(self) -> torch.Tensor:
        return self.inner.timesteps

    @property
    def init_noise_sigma(self) -> torch.Tensor:
        return self.inner.init_noise_sigma

    def _step_index(self, timestep: torch.Tensor) -> int:
        return int((self.inner.timesteps == timestep).nonzero()[0].item())

    def scale_model_input(self, sample: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        return self.inner.scale_model_input(sample, step=self._step_index(timestep))

    def step(self, model_output: torch.Tensor, timestep: torch.Tensor, sample: torch.Tensor) -> Any:
        prev = self.inner(sample, predicted_noise=model_output, step=self._step_index(timestep))
        return types.SimpleNamespace(prev_sample=prev)


def test_franken_solver_over_a_scheduler_matches_jax_euler() -> None:
    jax_solver = jax_solvers.Euler(num_inference_steps=30)
    port = solvers.FrankenSolver(_EulerSchedulerShim, num_inference_steps=30)
    _assert_tables_equal(jax_solver, port, ("timesteps",))
    assert float(port.scale_model_input(torch.ones(()), step=-1)) == pytest.approx(float(jax_solver.init_noise_sigma))
    got, want = _trajectories(jax_solver, port, scale_input=True)
    assert _rel(got, want) <= TOL
    rebuilt = port.rebuild(num_inference_steps=10)
    _assert_tables_equal(jax_solvers.Euler(num_inference_steps=10), rebuilt, ("timesteps",))
