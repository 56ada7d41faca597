"""Training checkpoint and resume; counterpart of
``refiners_tpu/training_utils/checkpointing.py``.

The same config (``directory``, ``interval``, ``keep``) and the same full
training state: each model's ``state_dict()``, each trained model's
optimizer ``state_dict()`` (in ``state.pt``, `torch.save` where the JAX
package uses orbax; read back with ``weights_only=True``), and the clock
counters with the scheduler's step in ``meta.json`` under the JAX package's
keys (``step``, ``epoch``, ``iteration``, ``scheduler_steps``).

What the port adds, so that ``restore`` then ``train()`` resumes a run:

- ``restore`` builds each trained model's optimizer (the port builds an
  optimizer at its first step) before it loads the optimizer's state;
- the clock resets its counters when training begins, so ``restore`` also
  keeps them and puts them back at ``on_train_begin``, which runs after the
  clock's (the JAX package's ``restore`` is undone by that reset);
- a checkpoint written at an epoch's end records the epoch as ended (the
  clock counts it only after the callbacks' ``on_epoch_end``), so the
  resumed run starts at the next epoch, and with `DataLoader` shuffles as
  the uninterrupted run did.

A checkpoint written mid-epoch (``save`` called directly) restarts that
epoch's batches from the first.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import TYPE_CHECKING, Any

import torch

from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig
from refiners_tpu_torch.training_utils.common import TimeValue, parse_number_unit_field

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer


class CheckpointConfig(CallbackConfig):
    directory: str = "checkpoints"
    interval: str = "1:epoch"
    keep: int = 3


class CheckpointCallback(Callback["Trainer[Any, Any]"]):
    def __init__(self, config: CheckpointConfig) -> None:
        self.config = config
        self.interval: TimeValue = parse_number_unit_field(config.interval)
        self.directory = Path(config.directory)
        self._resume: dict[str, int] | None = None

    def save(self, trainer: "Trainer[Any, Any]", tag: str, epochs_done: int | None = None) -> Path:
        """Write the training state under ``directory / tag``; `epochs_done`
        (default: the clock's epoch) is the epoch a resumed run starts at."""
        path = (self.directory / tag).absolute()
        path.mkdir(parents=True, exist_ok=True)
        state: dict[str, Any] = {}
        for name, item in trainer.models.items():
            state[f"model_{name}"] = item.model.state_dict()
            if item.optimizer is not None:
                state[f"opt_{name}"] = item.optimizer.state_dict()
        torch.save(state, path / "state.pt")
        meta = {
            "step": trainer.clock.step,
            "epoch": trainer.clock.epoch if epochs_done is None else epochs_done,
            "iteration": trainer.clock.iteration,
            "scheduler_steps": trainer._scheduler_steps,
        }
        (path / "meta.json").write_text(json.dumps(meta))
        self._prune()
        return path

    def restore(self, trainer: "Trainer[Any, Any]", tag: str) -> None:
        path = (self.directory / tag).absolute()
        state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        meta = json.loads((path / "meta.json").read_text())
        trainer._scheduler_steps = meta["scheduler_steps"]  # first: the optimizers' learning rate follows it
        for name, item in trainer.models.items():
            item.model.load_state_dict(state[f"model_{name}"])
            if f"opt_{name}" in state:
                trainer._optimizer_for(item).load_state_dict(state[f"opt_{name}"])
        self._set_clock(trainer, meta)
        self._resume = meta

    @staticmethod
    def _set_clock(trainer: "Trainer[Any, Any]", meta: dict[str, int]) -> None:
        trainer.clock.step = meta["step"]
        trainer.clock.epoch = meta["epoch"]
        trainer.clock.iteration = meta["iteration"]

    def _prune(self) -> None:
        if not self.directory.exists():
            return
        tags = sorted(self.directory.iterdir(), key=lambda p: p.stat().st_mtime)
        for old in tags[: -self.config.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def on_train_begin(self, trainer: "Trainer[Any, Any]") -> None:
        if self._resume is not None:  # after the clock's reset: the restored counters
            self._set_clock(trainer, self._resume)
            self._resume = None

    def on_epoch_end(self, trainer: "Trainer[Any, Any]") -> None:
        if trainer.clock.is_due(self.interval):
            self.save(trainer, f"step_{trainer.clock.step}", epochs_done=trainer.clock.epoch + 1)
