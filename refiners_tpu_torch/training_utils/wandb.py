"""Weights & Biases logging callback; counterpart of
``refiners_tpu/training_utils/wandb.py``: the same config, the same keys
logged at the same events and clock steps. ``wandb`` is imported when the
callback is built, never at module import. Under ``[training.mesh]`` every
rank runs the Trainer; the first rank of the process group alone starts a
run and logs."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig, first_rank

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer


class WandbConfig(CallbackConfig):
    allow_extra = True  # pydantic's extra="allow", as in the JAX package

    mode: str = "online"
    project: str = "refiners-tpu"
    entity: str | None = None
    name: str | None = None
    tags: list[str] = dataclasses.field(default_factory=list)
    group: str | None = None
    notes: str | None = None


class WandbCallback(Callback["Trainer[Any, Any]"]):
    def __init__(self, config: WandbConfig) -> None:
        self.config = config
        self.epoch_losses: list[float] = []
        self.iteration_losses: list[float] = []
        self.run: Any = None
        if not first_rank():
            return
        import wandb  # type: ignore

        self.run = wandb.init(
            mode=config.mode,
            project=config.project,
            entity=config.entity,
            name=config.name,
            tags=config.tags,
            group=config.group,
            notes=config.notes,
        )

    def log(self, data: dict[str, Any], step: int) -> None:
        if self.run is not None:
            self.run.log(data, step=step)

    def on_compute_loss_end(self, trainer: "Trainer[Any, Any]") -> None:
        assert trainer.loss is not None
        loss = trainer.loss.item()
        self.epoch_losses.append(loss)
        self.iteration_losses.append(loss)
        self.log({"step_loss": loss}, step=trainer.clock.step)

    def on_optimizer_step_end(self, trainer: "Trainer[Any, Any]") -> None:
        avg = sum(self.iteration_losses) / max(len(self.iteration_losses), 1)
        self.log(
            {
                "average_iteration_loss": avg,
                "grad_norm": trainer.grad_norm,
                "learning_rate": trainer.current_learning_rate(),
            },
            step=trainer.clock.step,
        )
        self.iteration_losses = []

    def on_epoch_end(self, trainer: "Trainer[Any, Any]") -> None:
        avg = sum(self.epoch_losses) / max(len(self.epoch_losses), 1)
        self.log({"average_epoch_loss": avg, "epoch": trainer.clock.epoch}, step=trainer.clock.step)
        self.epoch_losses = []

    def on_train_end(self, trainer: "Trainer[Any, Any]") -> None:
        if self.run is not None:
            self.run.finish()


class WandbMixin:
    """Trainer mixin exposing `wandb_log`, through the ``wandb`` callback."""

    def wandb_log(self, data: dict[str, Any]) -> None:
        callback = getattr(self, "callbacks", {}).get("wandb")
        if callback is not None:
            callback.log(data, step=self.clock.step)  # type: ignore[attr-defined]
