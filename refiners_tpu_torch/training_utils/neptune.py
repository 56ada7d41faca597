"""Neptune logging callback; counterpart of
``refiners_tpu/training_utils/neptune.py``: the same config and the same
series appended at the same events. ``neptune`` is imported when the
callback is built, never at module import. Under ``[training.mesh]`` the
first rank of the process group alone starts a run and logs."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig, first_rank

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer


class NeptuneConfig(CallbackConfig):
    allow_extra = True  # pydantic's extra="allow", as in the JAX package

    project: str = "refiners-tpu"
    name: str | None = None
    tags: list[str] = dataclasses.field(default_factory=list)


class NeptuneCallback(Callback["Trainer[Any, Any]"]):
    def __init__(self, config: NeptuneConfig) -> None:
        self.config = config
        self.run: Any = None
        if first_rank():
            import neptune  # type: ignore

            self.run = neptune.init_run(project=config.project, name=config.name, tags=config.tags)

    def log(self, key: str, value: Any) -> None:
        if self.run is not None:
            self.run[key].append(value)

    def on_compute_loss_end(self, trainer: "Trainer[Any, Any]") -> None:
        assert trainer.loss is not None
        self.log("train/step_loss", trainer.loss.item())

    def on_optimizer_step_end(self, trainer: "Trainer[Any, Any]") -> None:
        self.log("train/grad_norm", trainer.grad_norm)
        self.log("train/learning_rate", trainer.current_learning_rate())

    def on_train_end(self, trainer: "Trainer[Any, Any]") -> None:
        if self.run is not None:
            self.run.stop()


class NeptuneMixin:
    """Trainer mixin exposing `neptune_log`, through the ``neptune`` callback."""

    def neptune_log(self, key: str, value: Any) -> None:
        callback = getattr(self, "callbacks", {}).get("neptune")
        if callback is not None:
            callback.log(key, value)
