"""Training time-values, seeding, small helpers; counterpart of
``refiners_tpu/training_utils/common.py``."""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

import numpy as np
import torch

from refiners_tpu_torch.fluxion import rng


def count_learnable_parameters(parameters: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in parameters)


def human_readable_number(number: int) -> str:
    value = float(number)
    for unit in ["", "K", "M", "G", "T", "P"]:
        if abs(value) < 1000:
            return f"{value:.1f}{unit}"
        value /= 1000
    return f"{value:.1f}E"


def seed_everything(seed: int | None = None) -> None:
    """Seed python, numpy, torch (every device) and the fluxion generators."""
    if seed is None:
        seed = random.randint(0, 2**32 - 1)
    random.seed(a=seed)
    np.random.seed(seed=seed)
    torch.manual_seed(seed)
    rng.manual_seed(seed)


class scoped_seed:
    """Context manager/decorator fixing the seed within a scope; the random
    states from before the scope come back after it."""

    def __init__(self, seed: int | Callable[..., int] | None = None):
        self.seed = seed
        self.actual_seed: int | None = None

    def __call__(self, func: Callable[..., Any]) -> Callable[..., Any]:
        def inner_wrapper(*args: Any, **kwargs: Any) -> Any:
            self.actual_seed = self.seed(*args, **kwargs) if callable(self.seed) else self.seed
            with self:
                return func(*args, **kwargs)

        return inner_wrapper

    def __enter__(self) -> None:
        seed = self.actual_seed if self.actual_seed is not None else (self.seed() if callable(self.seed) else self.seed)
        self.random_state = random.getstate()
        self.numpy_state = np.random.get_state()
        self.torch_state = torch.get_rng_state()
        self.cuda_states = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None
        self.fluxion_state = (rng._seed, dict(rng._generators))
        seed_everything(seed)

    def __exit__(self, exc_type: Any, exc_value: Any, traceback: Any) -> None:
        random.setstate(self.random_state)
        np.random.set_state(self.numpy_state)
        torch.set_rng_state(self.torch_state)
        if self.cuda_states is not None:
            torch.cuda.set_rng_state_all(self.cuda_states)
        rng._seed, generators = self.fluxion_state
        rng._generators.clear()
        rng._generators.update(generators)


@dataclass
@runtime_checkable
class TimeValue(Protocol):
    """`"N:step|epoch|iteration"` mini-language."""

    number: int

    @property
    def unit(self) -> "TimeUnit":
        match self.__class__.__name__:
            case "Step":
                return Step
            case "Epoch":
                return Epoch
            case "Iteration":
                return Iteration
            case _:
                raise ValueError(f"Unsupported time unit: {self.__class__.__name__}")

    @classmethod
    def from_str(cls, value: str) -> "TimeValue":
        number, unit = value.lower().split(":")
        number_int = int(number.strip())
        match unit.strip():
            case "step":
                return Step(number_int)
            case "epoch":
                return Epoch(number_int)
            case "iteration":
                return Iteration(number_int)
            case _:
                raise ValueError(f"Incorrect time value format: {value}")


@dataclass
class Step(TimeValue):
    number: int


@dataclass
class Epoch(TimeValue):
    number: int


@dataclass
class Iteration(TimeValue):
    number: int


TimeUnit = type[Step] | type[Epoch] | type[Iteration]
TimeValueInput = str | int | dict[str, str | int] | TimeValue


def parse_number_unit_field(value: TimeValueInput) -> TimeValue:
    match value:
        case str(value_str):
            return TimeValue.from_str(value_str)
        case int(number):
            return Step(number=number)
        case TimeValue(number=_):
            return value  # type: ignore[return-value]
        case _:
            raise ValueError(f"Unsupported value format: {value}")
