"""Training harness; counterpart of ``refiners_tpu/training_utils/``.

Every module of the JAX package's: the Trainer, callbacks, the clock, the
TOML config (dataclasses and `tomllib`, no pydantic), the time values and
seeding helpers, the data loader (on `torch.utils.data.DataLoader`),
checkpointing (`torch.save`), ForceCommit, the wandb and neptune loggers,
the Hugging Face datasets helper and the DINOv2 Fréchet distance
(``training_utils.metrics`` and ``training_utils.huggingface_datasets``,
imported from their modules as in the JAX package); Lion and Prodigy are
``training_utils.optimizers``. ``wandb``, ``neptune`` and ``datasets`` are
imported only when a logger is built or a dataset loaded.
"""

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig
from refiners_tpu_torch.training_utils.checkpointing import CheckpointCallback, CheckpointConfig
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
from refiners_tpu_torch.training_utils.data_loader import (
    DataLoader,
    DataLoaderConfig,
    DatasetFromCallable,
    create_data_loader,
)
from refiners_tpu_torch.training_utils.forcecommit import ForceCommit, ForceCommitConfig
from refiners_tpu_torch.training_utils.neptune import NeptuneConfig, NeptuneMixin
from refiners_tpu_torch.training_utils.optimizers import Lion, Prodigy
from refiners_tpu_torch.training_utils.trainer import ModelItem, Trainer, register_callback, register_model
from refiners_tpu_torch.training_utils.wandb import WandbConfig, WandbMixin

__all__ = [
    "Callback",
    "CallbackConfig",
    "CheckpointCallback",
    "CheckpointConfig",
    "ClockConfig",
    "TrainingClock",
    "Epoch",
    "Iteration",
    "Step",
    "TimeUnit",
    "TimeValue",
    "WandbMixin",
    "WandbConfig",
    "NeptuneMixin",
    "NeptuneConfig",
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
    "DataLoader",
    "DataLoaderConfig",
    "DatasetFromCallable",
    "create_data_loader",
    "ForceCommit",
    "ForceCommitConfig",
    "Lion",
    "Prodigy",
    "ModelItem",
    "Trainer",
    "register_callback",
    "register_model",
]
