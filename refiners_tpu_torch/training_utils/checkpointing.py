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

The optimizer's state is saved by parameter name: each parameter's state
under its name in the model, each parameter group's hyperparameters with
the names of its parameters. ``restore`` maps the names onto the groups and
indices of the optimizer it builds, so a state restores into other groups
than it was saved from (`OptimizerConfig.get` gives the parameters split
over "tensor" a group of their own, a tensor size of 1 none).

Under ``[training.mesh]`` every rank calls ``save`` and ``restore``. The
file holds whole tensors: each tensor split over "tensor" is gathered (the
ranks of its group together), the first rank of the process group alone
writes and prunes, and the others wait for it. ``restore`` reads the same
file on every rank and gives each split parameter, and its optimizer
state, this rank's shard. Weights and optimizer state restore at any mesh,
as the JAX package's do.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import TYPE_CHECKING, Any

import torch
import torch.distributed as dist

from refiners_tpu_torch.parallel.sharding import distribute_like, full
from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig, first_rank
from refiners_tpu_torch.training_utils.common import TimeValue, parse_number_unit_field

if TYPE_CHECKING:
    from refiners_tpu_torch.training_utils.trainer import Trainer


def _whole(value: Any) -> Any:
    """`value` (a state dict, nested) with each split tensor gathered whole."""
    if isinstance(value, torch.Tensor):
        return full(value)
    if isinstance(value, dict):
        return {k: _whole(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_whole(v) for v in value)
    return value


def _named_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> dict[str, Any]:
    """The optimizer's ``state_dict()`` keyed by the names of `model`'s
    parameters, split tensors gathered whole: ``state`` maps a parameter's
    name to its state, each of ``param_groups`` lists its parameters' names."""
    names = {id(p): name for name, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    saved = optimizer.state_dict()
    return {
        "state": {names[id(params[i])]: _whole(values) for i, values in saved["state"].items()},
        "param_groups": [
            {**group, "params": [names[id(params[i])] for i in group["params"]]} for group in saved["param_groups"]
        ],
    }


def _indexed_state(saved: dict[str, Any], optimizer: torch.optim.Optimizer, model: torch.nn.Module) -> dict[str, Any]:
    """A `_named_state` as a ``state_dict()`` of `optimizer`: each name at
    its parameter's index in the optimizer's own groups, each group with the
    hyperparameters of the saved group of its first parameter, and each
    per-parameter tensor shaped like its parameter placed as the parameter
    is (`distribute_like`)."""
    names = {id(p): name for name, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    index = {names[id(p)]: i for i, p in enumerate(params)}
    saved_group = {name: group for group in saved["param_groups"] for name in group["params"]}
    state = {
        index[name]: {k: distribute_like(v, params[index[name]]) if _like(v, params[index[name]]) else v
                      for k, v in values.items()}
        for name, values in saved["state"].items()
    }  # fmt: skip
    groups: list[dict[str, Any]] = []
    for group in optimizer.param_groups:
        start = sum(len(g["params"]) for g in groups)
        hyperparameters = saved_group[names[id(group["params"][0])]]
        groups.append({**hyperparameters, "params": list(range(start, start + len(group["params"])))})
    return {"state": state, "param_groups": groups}


def _like(value: Any, param: torch.Tensor) -> bool:
    return isinstance(value, torch.Tensor) and value.shape == param.shape


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
        state: dict[str, Any] = {}
        for name, item in trainer.models.items():
            state[f"model_{name}"] = _whole(item.model.state_dict())
            if item.optimizer is not None:
                state[f"opt_{name}"] = _named_state(item.optimizer, item.model)
        if first_rank():
            path.mkdir(parents=True, exist_ok=True)
            torch.save(state, path / "state.pt")
            meta = {
                "step": trainer.clock.step,
                "epoch": trainer.clock.epoch if epochs_done is None else epochs_done,
                "iteration": trainer.clock.iteration,
                "scheduler_steps": trainer._scheduler_steps,
            }
            (path / "meta.json").write_text(json.dumps(meta))
            self._prune()
        if dist.is_initialized():
            dist.barrier()
        return path

    def restore(self, trainer: "Trainer[Any, Any]", tag: str) -> None:
        path = (self.directory / tag).absolute()
        state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        meta = json.loads((path / "meta.json").read_text())
        trainer._scheduler_steps = meta["scheduler_steps"]  # first: the optimizers' learning rate follows it
        for name, item in trainer.models.items():
            current = item.model.state_dict()
            item.model.load_state_dict(
                {k: distribute_like(v, current[k]) if k in current else v for k, v in state[f"model_{name}"].items()}
            )
            if f"opt_{name}" in state:
                optimizer = trainer._optimizer_for(item)
                optimizer.load_state_dict(_indexed_state(state[f"opt_{name}"], optimizer, item.model))
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
