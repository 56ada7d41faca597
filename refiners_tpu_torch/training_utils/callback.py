"""Training callbacks; counterpart of ``refiners_tpu/training_utils/callback.py``.
`CallbackConfig` is a config dataclass (see ``config_base.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Generic, TypeVar

import torch.distributed as dist

from refiners_tpu_torch.training_utils.config_base import Config

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer

T = TypeVar("T", bound="Trainer[Any, Any]")


class CallbackConfig(Config):
    pass


def first_rank() -> bool:
    """Whether this process writes what the run shares (logs, files): with
    no process group, or as rank 0 of it (every rank runs the Trainer under
    ``[training.mesh]``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Callback(Generic[T]):
    def on_init_begin(self, trainer: T) -> None: ...

    def on_init_end(self, trainer: T) -> None: ...

    def on_train_begin(self, trainer: T) -> None: ...

    def on_train_end(self, trainer: T) -> None: ...

    def on_epoch_begin(self, trainer: T) -> None: ...

    def on_epoch_end(self, trainer: T) -> None: ...

    def on_step_begin(self, trainer: T) -> None: ...

    def on_step_end(self, trainer: T) -> None: ...

    def on_backward_begin(self, trainer: T) -> None: ...

    def on_backward_end(self, trainer: T) -> None: ...

    def on_optimizer_step_begin(self, trainer: T) -> None: ...

    def on_optimizer_step_end(self, trainer: T) -> None: ...

    def on_compute_loss_begin(self, trainer: T) -> None: ...

    def on_compute_loss_end(self, trainer: T) -> None: ...

    def on_evaluate_begin(self, trainer: T) -> None: ...

    def on_evaluate_end(self, trainer: T) -> None: ...

    def on_lr_scheduler_step_begin(self, trainer: T) -> None: ...

    def on_lr_scheduler_step_end(self, trainer: T) -> None: ...
