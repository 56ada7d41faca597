"""Training configuration, read from TOML; counterpart of
``refiners_tpu/training_utils/config.py``.

Same class names, field names, defaults and TOML schema as the JAX
package; the classes are dataclasses loaded with `tomllib` (see
``config_base.py``), not pydantic models. Optimizers are `torch.optim`'s,
and Lion and Prodigy from ``training_utils/optimizers.py`` (the JAX
package's come from optax), mapped as the JAX package maps them:
``AdamW8bit`` runs full-precision AdamW, ``Lion8bit`` Lion, ``Prodigy``
Prodigy with ``safeguard_warmup``; every default (betas, eps, weight decay
1e-2) is the JAX package's. LR schedules are the same multiplier functions,
applied by the Trainer at every optimizer step.

The ``[training.mesh]`` section (`MeshConfig`) trains over a ("data",
"tensor") mesh of the running process group (see the Trainer).
``training.jit_step`` runs the loss and its gradient as one compiled
program (`fluxion.graphs.Program`: a CUDA graph on the card), as the JAX
package jits them.
"""

from __future__ import annotations

import dataclasses
import math
from enum import Enum
from pathlib import Path
from typing import Any, Callable, Iterable, Literal, TypeVar

import torch
from torch.distributed.tensor import DTensor

from refiners_tpu_torch.training_utils.clock import ClockConfig
from refiners_tpu_torch.training_utils.common import Iteration, Step, TimeValue, parse_number_unit_field
from refiners_tpu_torch.training_utils.config_base import Config, parsed
from refiners_tpu_torch.training_utils.optimizers import Lion, Prodigy

def _tuple(value: Any) -> tuple[Any, ...]:
    return tuple(value)


class MeshConfig(Config):
    """Device-mesh parallelism for training: the batch split over "data"
    (gradients averaged over it); with ``tensor > 1`` the attention and
    feed-forward weights split by `parallel.ATTENTION_TP_RULES` too."""

    data: int | None = None  # None: every remaining rank on the data axis
    tensor: int = 1
    tensor_parallel_rules: bool = True


def _mesh_config(value: Any) -> MeshConfig:
    return value if isinstance(value, MeshConfig) else MeshConfig.from_dict(value)


class TrainingConfig(Config):
    device: str = "cuda"
    dtype: str = "float32"
    duration: TimeValue = parsed(parse_number_unit_field, factory=lambda: Iteration(1))
    seed: int = 0
    gradient_accumulation: Step = parsed(parse_number_unit_field, factory=lambda: Step(1))
    gradient_clipping_max_norm: float | None = None
    jit_step: bool = False
    mesh: MeshConfig | None = parsed(_mesh_config, default=None)  # [training.mesh] enables DP/TP


class Optimizers(str, Enum):
    SGD = "SGD"
    Adam = "Adam"
    AdamW = "AdamW"
    AdamW8bit = "AdamW8bit"
    Lion8bit = "Lion8bit"
    Prodigy = "Prodigy"


class LRSchedulerType(str, Enum):
    STEP_LR = "StepLR"
    EXPONENTIAL_LR = "ExponentialLR"
    REDUCE_LR_ON_PLATEAU = "ReduceLROnPlateau"
    COSINE_ANNEALING_LR = "CosineAnnealingLR"
    CONSTANT_LR = "ConstantLR"
    LAMBDA_LR = "LambdaLR"
    ONE_CYCLE_LR = "OneCycleLR"
    MULTIPLICATIVE_LR = "MultiplicativeLR"
    COSINE_ANNEALING_WARM_RESTARTS = "CosineAnnealingWarmRestarts"
    CYCLIC_LR = "CyclicLR"
    MULTI_STEP_LR = "MultiStepLR"
    DEFAULT = "ConstantLR"


class LRSchedulerConfig(Config):
    type: LRSchedulerType = parsed(LRSchedulerType, default=LRSchedulerType.DEFAULT)
    update_interval: TimeValue = parsed(parse_number_unit_field, factory=lambda: Iteration(1))
    warmup: TimeValue = parsed(parse_number_unit_field, factory=lambda: Iteration(0))
    gamma: float = 0.1
    lr_lambda: Callable[[int], float] | None = None
    mode: Literal["min", "max"] = "min"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    cooldown: int = 0
    milestones: list[int] = dataclasses.field(default_factory=list)
    base_lr: float = 1e-7
    min_lr: float | list[float] = 0
    max_lr: float | list[float] = 0
    eta_min: float = 0

    def multiplier(self, t: int, base_lr: float) -> float:
        """LR multiplier after `t` scheduler steps (torch-scheduler semantics)."""
        n = self.update_interval.number
        match self.type:
            case LRSchedulerType.CONSTANT_LR | LRSchedulerType.DEFAULT:
                return 1.0
            case LRSchedulerType.STEP_LR:
                return self.gamma ** (t // n)
            case LRSchedulerType.EXPONENTIAL_LR:
                return self.gamma**t
            case LRSchedulerType.COSINE_ANNEALING_LR:
                eta_min = float(self.eta_min)
                return (eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / n)) / 2) / base_lr
            case LRSchedulerType.COSINE_ANNEALING_WARM_RESTARTS:
                t_cur = t % n
                return (1 + math.cos(math.pi * t_cur / n)) / 2
            case LRSchedulerType.LAMBDA_LR:
                assert self.lr_lambda is not None, "lr_lambda must be specified to use LambdaLR"
                return self.lr_lambda(t)
            case LRSchedulerType.MULTIPLICATIVE_LR:
                assert self.lr_lambda is not None, "lr_lambda must be specified to use MultiplicativeLR"
                m = 1.0
                for i in range(1, t + 1):
                    m *= self.lr_lambda(i)
                return m
            case LRSchedulerType.MULTI_STEP_LR:
                return self.gamma ** sum(1 for m in self.milestones if t >= m)
            case LRSchedulerType.ONE_CYCLE_LR:
                max_lr = self.max_lr if isinstance(self.max_lr, float) else self.max_lr[0]
                pct = min(t / max(n, 1), 1.0)
                if pct < 0.3:
                    lr = base_lr + (max_lr - base_lr) * pct / 0.3
                else:
                    lr = max_lr * (1 + math.cos(math.pi * (pct - 0.3) / 0.7)) / 2
                return lr / base_lr
            case LRSchedulerType.CYCLIC_LR:
                max_lr = self.max_lr if isinstance(self.max_lr, float) else self.max_lr[0]
                cycle_pos = (t % (2 * n)) / n if n else 0.0
                frac = cycle_pos if cycle_pos <= 1 else 2 - cycle_pos
                return (self.base_lr + (max_lr - self.base_lr) * frac) / base_lr
            case LRSchedulerType.REDUCE_LR_ON_PLATEAU:
                return 1.0  # handled statefully by the trainer
            case _:
                raise ValueError(f"Unknown scheduler type: {self.type}")


def _by_type(params: Iterable[torch.nn.Parameter]) -> list[Any]:
    """The parameters, with those that are `DTensor`s (tensor-parallel
    splits) in a group of their own: torch's multi-tensor steps (the
    default on the card) take lists of one tensor type."""
    params = list(params)
    split = [p for p in params if isinstance(p, DTensor)]
    if not split or len(split) == len(params):
        return params
    return [{"params": [p for p in params if not isinstance(p, DTensor)]}, {"params": split}]


class OptimizerConfig(Config):
    optimizer: Optimizers = parsed(Optimizers)
    learning_rate: float = 1e-4
    betas: tuple[float, float] = parsed(_tuple, default=(0.9, 0.999))
    eps: float = 1e-8
    weight_decay: float = 1e-2

    def get(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float | None = None,
        betas: tuple[float, float] | None = None,
        eps: float | None = None,
        weight_decay: float | None = None,
    ) -> torch.optim.Optimizer:
        """The optimizer over `params`; each argument left None takes this
        config's value. SGD and Adam add the decay to the gradient (the JAX
        package's `add_decayed_weights` before the transform); AdamW, Lion
        and Prodigy decay the weights directly. There is no 8-bit state:
        ``AdamW8bit`` is AdamW and ``Lion8bit`` Lion, as in the JAX package;
        Prodigy takes its default eps, as optax's does there."""
        lr = learning_rate if learning_rate is not None else self.learning_rate
        if self.optimizer in (Optimizers.SGD, Optimizers.Adam, Optimizers.AdamW, Optimizers.AdamW8bit):
            params = _by_type(params)
        b = tuple(betas) if betas is not None else self.betas
        e = eps if eps is not None else self.eps
        wd = weight_decay if weight_decay is not None else self.weight_decay
        match self.optimizer:
            case Optimizers.SGD:
                return torch.optim.SGD(params, lr=lr, weight_decay=wd)
            case Optimizers.Adam:
                return torch.optim.Adam(params, lr=lr, betas=b, eps=e, weight_decay=wd)
            case Optimizers.AdamW | Optimizers.AdamW8bit:
                return torch.optim.AdamW(params, lr=lr, betas=b, eps=e, weight_decay=wd)
            case Optimizers.Lion8bit:
                return Lion(params, lr=lr, betas=b, weight_decay=wd)
            case Optimizers.Prodigy:
                return Prodigy(params, lr=lr, betas=b, weight_decay=wd, safeguard_warmup=True)


class ModelConfig(Config):
    requires_grad: bool | None = None
    learning_rate: float | None = None
    betas: tuple[float, float] | None = parsed(_tuple, default=None)
    eps: float | None = None
    weight_decay: float | None = None


T = TypeVar("T", bound="BaseConfig")


class BaseConfig(Config):
    training: TrainingConfig
    optimizer: OptimizerConfig
    lr_scheduler: LRSchedulerConfig
    clock: ClockConfig = ClockConfig()

    @classmethod
    def load_from_toml(cls: type[T], toml_path: Path | str) -> T:
        import tomllib

        with open(toml_path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    @classmethod
    def load_from_toml_string(cls: type[T], text: str) -> T:
        import tomllib

        return cls.from_dict(tomllib.loads(text))
