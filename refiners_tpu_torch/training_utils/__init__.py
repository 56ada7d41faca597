"""Training harness; counterpart of ``refiners_tpu/training_utils/``.

Ported: the Trainer, callbacks, the clock, the TOML config (dataclasses and
`tomllib`, no pydantic), the time values and seeding helpers, and the DINOv2
Fréchet distance (``training_utils.metrics``, imported from its module as in
the JAX package). Not ported yet (ROADMAP.md, Queue 1 step 10):
checkpointing, the data loader, the wandb/neptune loggers, the Hugging Face
datasets helper and ForceCommit.
"""

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig
from refiners_tpu_torch.training_utils.clock import ClockConfig, TrainingClock
from refiners_tpu_torch.training_utils.common import (
    Epoch,
    Iteration,
    Step,
    TimeUnit,
    TimeValue,
    count_learnable_parameters,
    human_readable_number,
    parse_number_unit_field,
    scoped_seed,
    seed_everything,
)
from refiners_tpu_torch.training_utils.config import (
    BaseConfig,
    LRSchedulerConfig,
    LRSchedulerType,
    ModelConfig,
    OptimizerConfig,
    Optimizers,
    TrainingConfig,
)
from refiners_tpu_torch.training_utils.trainer import ModelItem, Trainer, register_callback, register_model

__all__ = [
    "Callback",
    "CallbackConfig",
    "ClockConfig",
    "TrainingClock",
    "Epoch",
    "Iteration",
    "Step",
    "TimeUnit",
    "TimeValue",
    "count_learnable_parameters",
    "human_readable_number",
    "parse_number_unit_field",
    "scoped_seed",
    "seed_everything",
    "BaseConfig",
    "LRSchedulerConfig",
    "LRSchedulerType",
    "ModelConfig",
    "OptimizerConfig",
    "Optimizers",
    "TrainingConfig",
    "ModelItem",
    "Trainer",
    "register_callback",
    "register_model",
]
