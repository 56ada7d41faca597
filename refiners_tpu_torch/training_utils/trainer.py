"""Generic Trainer; counterpart of ``refiners_tpu/training_utils/trainer.py``.

The same API (`Trainer[ConfigType, Batch]`, `register_model`,
`register_callback`, `compute_loss`, `create_data_iterable`, `train`,
`step`, `backward`, `current_learning_rate`) and the same callback event
order. What changes with PyTorch:

- the backward pass is ``loss.backward()`` in place of `jax.value_and_grad`:
  each step adds loss / N to the parameters' ``.grad`` (gradient
  accumulation over N steps), tensors created as zeros before the first
  step (an unused parameter has a zero gradient, as in the JAX package) and
  zeroed in place after each optimizer step;
- each model has one `torch.optim` optimizer, built at its first step; every
  optimizer step sets each ``param_group["lr"]`` to `current_learning_rate`,
  which gives the JAX package's per-step rebuild of the optax transform;
- gradients are clipped by their global norm, scale
  ``min(1, max_norm / (norm + 1e-6))``, as in the JAX package (and as
  `torch.nn.utils.clip_grads_with_norm_`, on a float32 global norm);
- ``training.dtype`` casts each registered model and ``training.device``
  places it: explicit, with no move to the CPU when the device is missing;
- a data iterable with a ``set_epoch`` method (`DataLoader`) is told the
  clock's epoch before each pass, so its shuffle follows the clock;
- under ``[training.mesh]`` every rank of the process group runs the same
  Trainer: each registered model is placed on the mesh (`shard_module`:
  the first rank's weights everywhere, the TP rules' Linears split over
  "tensor"), each batch split over "data" (`shard_batch`), and at each
  optimizer step the gradients are averaged over "data" before the
  clipping. The model is not wrapped (no ``DistributedDataParallel``), so
  its ``state_dict()`` keys stay the JAX package's. After the backward,
  ``loss`` is the mean of the ranks' losses, the loss of the whole batch;
- with ``training.jit_step``, `compute_loss`, ``(loss / N).backward()`` and
  the gradients' accumulation into ``.grad`` run as one compiled program
  (`fluxion.graphs.Program`: a CUDA graph on the card, eager on the CPU and
  on a gloo mesh), keyed by the trainer's modules and the batch's shapes,
  as the JAX package jits its loss and gradient. The graph adds into the
  same ``.grad`` tensors at every replay, the batch is copied into the
  program's own buffers, and a CUDA `torch.Generator` held by the trainer
  is registered with the graph. The norm, the clipping and the optimizer
  step stay outside, as in the JAX package;
- spans (`fluxion.tracing`): ``refiners.Trainer.step`` (its id the clock's
  step), ``refiners.Trainer.optimizer_step`` (averaging, norm, clipping,
  optimizer, learning rate) and in it ``refiners.wait.grad_norm``, the
  norm read back to the host.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass
from functools import cached_property, wraps
from typing import Any, Callable, Generic, Iterable, TypeVar

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from refiners_tpu_torch.fluxion import layers as fl
from refiners_tpu_torch.fluxion.graphs import Program
from refiners_tpu_torch.fluxion.tracing import span
from refiners_tpu_torch.fluxion.utils import str_to_dtype
from refiners_tpu_torch.parallel.sharding import is_split, local, sum_over_shards
from refiners_tpu_torch.training_utils.callback import Callback, CallbackConfig
from refiners_tpu_torch.training_utils.clock import ClockConfig, TrainingClock
from refiners_tpu_torch.training_utils.common import (
    Step,
    count_learnable_parameters,
    human_readable_number,
    scoped_seed,
)
from refiners_tpu_torch.training_utils.config import BaseConfig, LRSchedulerType, ModelConfig

logger = logging.getLogger("refiners_tpu_torch.training")

Batch = TypeVar("Batch")
ConfigType = TypeVar("ConfigType", bound=BaseConfig)


@dataclass
class ModelItem:
    name: str
    config: ModelConfig
    model: fl.Module
    trainable: bool
    optimizer: torch.optim.Optimizer | None = None


ModelRegistry = dict[str, ModelItem]
ModuleT = TypeVar("ModuleT", bound=fl.Module)
ModelConfigT = TypeVar("ModelConfigT", bound=ModelConfig)
CallbackT = TypeVar("CallbackT", bound=Callback[Any])
CallbackConfigT = TypeVar("CallbackConfigT", bound=CallbackConfig)


def register_model():
    def decorator(func: Callable[[Any, ModelConfigT], ModuleT]) -> ModuleT:
        @wraps(func)
        def wrapper(self: "Trainer[BaseConfig, Any]", config: ModelConfigT) -> fl.Module:
            name = func.__name__
            model = func(self, config).to(device=self.device, dtype=self.dtype)
            if (mesh := self.mesh) is not None:
                from refiners_tpu_torch.parallel import ATTENTION_TP_RULES, shard_module

                mesh_config = self.config.training.mesh
                rules = ATTENTION_TP_RULES if (mesh_config and mesh_config.tensor_parallel_rules) else []
                shard_module(model, mesh, rules)
            trainable = config.requires_grad if config.requires_grad is not None else True
            model.requires_grad_(trainable)
            numel = sum(p.numel() for p in model.parameters())
            logger.info(f"Number of parameters in {name}: {human_readable_number(numel)} (trainable={trainable})")
            self.models[name] = ModelItem(name=name, config=config, model=model, trainable=trainable)
            setattr(self, name, model)
            return model

        return wrapper  # type: ignore[return-value]

    return decorator


def register_callback():
    def decorator(func: Callable[[Any, CallbackConfigT], CallbackT]) -> CallbackT:
        @wraps(func)
        def wrapper(self: "Trainer[BaseConfig, Any]", config: CallbackConfigT) -> Callback[Any]:
            name = func.__name__
            callback = func(self, config)
            self.callbacks[name] = callback
            setattr(self, name, callback)
            return callback

        return wrapper  # type: ignore[return-value]

    return decorator


def _global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The float32 (float64 for float64 gradients) norm of all the gradients
    as they are (no float32 copies); the norm of a `DTensor` split over
    "tensor" is over all its shards."""
    dtype = torch.float64 if any(g.dtype == torch.float64 for g in grads) else torch.float32
    norms = torch.stack([torch.linalg.vector_norm(local(g), dtype=dtype) for g in grads])
    split = [i for i, g in enumerate(grads) if is_split(g)]
    if split:
        at = torch.tensor(split, device=norms.device)
        norms[at] = sum_over_shards(norms[at] ** 2, [grads[i] for i in split]).sqrt()
    return torch.linalg.vector_norm(norms)


_BUCKET_ELEMENTS = 2**25  # gradients averaged over "data" in flat buckets of at most this many elements


def _buckets(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """The tensors in runs of one dtype and device, each run cut after
    `_BUCKET_ELEMENTS` elements."""
    buckets: list[list[torch.Tensor]] = []
    open_: dict[tuple[torch.dtype, torch.device], tuple[list[torch.Tensor], int]] = {}
    for t in tensors:
        key = (t.dtype, t.device)
        bucket, n = open_.get(key, ([], 0))
        if not bucket:
            buckets.append(bucket)
        bucket.append(t)
        n += t.numel()
        open_[key] = (bucket, n) if n < _BUCKET_ELEMENTS else ([], 0)
    return buckets


class Trainer(Generic[ConfigType, Batch], ABC):
    def __init__(self, config: ConfigType) -> None:
        self._models: ModelRegistry = {}
        self._callbacks: dict[str, Callback[Any]] = {}
        self.config = config
        self.loss: torch.Tensor | None = None
        self.grad_norm: float = 0.0
        self._scheduler_steps = 0
        self._plateau: dict[str, Any] = {"best": None, "bad": 0, "cooldown": 0, "factor": 1.0}
        self._step_program: Program | None = None
        self._load_callbacks()
        self._call_callbacks(event_name="on_init_begin")
        self._load_models()
        self._call_callbacks(event_name="on_init_end")

    @register_callback()
    def clock(self, config: ClockConfig) -> TrainingClock:
        return TrainingClock(
            training_duration=self.config.training.duration,
            gradient_accumulation=self.config.training.gradient_accumulation,
            verbose=config.verbose,
        )

    @property
    def models(self) -> ModelRegistry:
        return self._models

    @property
    def callbacks(self) -> dict[str, Callback[Any]]:
        return self._callbacks

    @cached_property
    def dtype(self) -> torch.dtype:
        return str_to_dtype(self.config.training.dtype)

    @cached_property
    def device(self) -> torch.device:
        return torch.device(self.config.training.device)

    @cached_property
    def mesh(self) -> Any:
        """The ("data", "tensor") `DeviceMesh` of ``[training.mesh]`` over the
        running process group, on the training device's type; None without
        the section."""
        config = self.config.training.mesh
        if config is None:
            return None
        from refiners_tpu_torch.parallel import make_mesh

        return make_mesh(data=config.data, tensor=config.tensor, device_type=self.device.type)

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows of every tensor of `batch` (nested in dicts,
        lists and tuples) whose leading axis divides the mesh's "data" size;
        the rest whole. The batch itself without a mesh."""
        if self.mesh is None:
            return batch
        from refiners_tpu_torch.parallel import shard_inputs

        if isinstance(batch, torch.Tensor):
            return shard_inputs(self.mesh, batch)[0] if batch.ndim >= 1 else batch
        if isinstance(batch, dict):
            return type(batch)((k, self.shard_batch(v)) for k, v in batch.items())
        if isinstance(batch, (list, tuple)):
            return type(batch)(self.shard_batch(v) for v in batch)
        return batch

    def _average_over_data(self, tensors: list[torch.Tensor]) -> None:
        """Average the tensors (a `DTensor`'s local shard) over the mesh's
        "data" axis, in place: flattened into buckets (`_buckets`), one
        all-reduce a bucket; nothing at a "data" size of 1."""
        group = self.mesh.get_group("data")
        size = dist.get_world_size(group)
        if size == 1:
            return
        for bucket in _buckets([local(t) for t in tensors]):
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            for t, average in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                t.copy_(average)

    @property
    def trainable_models(self) -> dict[str, fl.Module]:
        return {name: item.model for name, item in self.models.items() if item.trainable}

    @property
    def learnable_parameters(self) -> list[torch.nn.Parameter]:
        return [p for m in self.trainable_models.values() for p in m.parameters() if p.requires_grad]

    @property
    def learnable_parameter_count(self) -> int:
        return count_learnable_parameters(self.learnable_parameters)

    # -- learning rate -------------------------------------------------------

    def _lr_multiplier(self, model_config: ModelConfig) -> float:
        cfg = self.config.lr_scheduler
        # `is not None`, not truthiness: an explicit per-model lr of 0.0 must
        # freeze the model, not fall back to the global learning rate
        base = (
            model_config.learning_rate
            if model_config.learning_rate is not None
            else self.config.optimizer.learning_rate
        )
        warmup = (
            cfg.warmup.number
            if isinstance(cfg.warmup, Step)
            else cfg.warmup.number * self.clock.gradient_accumulation.number
        )
        t = self._scheduler_steps
        if warmup > 0 and t <= warmup:
            return max(t, 0) / warmup
        mult = cfg.multiplier(t - warmup, base)
        return mult * self._plateau["factor"]

    def current_learning_rate(self, name: str | None = None) -> float:
        item = next(iter(self.models.values())) if name is None else self.models[name]
        base = item.config.learning_rate if item.config.learning_rate is not None else self.config.optimizer.learning_rate
        return base * self._lr_multiplier(item.config)

    def _optimizer_for(self, item: ModelItem) -> torch.optim.Optimizer:
        """The model's optimizer (built at its first step), with every
        parameter group's lr set to the current learning rate."""
        lr = self.current_learning_rate(item.name)
        if item.optimizer is None:
            c = item.config
            item.optimizer = self.config.optimizer.get(
                params=item.model.parameters(), learning_rate=lr, betas=c.betas, eps=c.eps, weight_decay=c.weight_decay
            )
        for group in item.optimizer.param_groups:
            group["lr"] = lr
        return item.optimizer

    # -- loss / gradients ----------------------------------------------------

    @abstractmethod
    def compute_loss(self, batch: Batch) -> torch.Tensor: ...

    @abstractmethod
    def create_data_iterable(self) -> Iterable[Batch]: ...

    @cached_property
    def data_iterable(self) -> Iterable[Batch]:
        return self.create_data_iterable()

    # -- optimization --------------------------------------------------------

    def _loss_and_backward(
        self, modules: list[torch.nn.Module], batch: Batch, accum: int, generators: list[torch.Generator]
    ) -> torch.Tensor:
        """The loss of `batch`, its gradient / `accum` added into ``.grad``:
        the ``jit_step`` program (`modules` and `generators` are the
        trainer's own, named for the program's key and its graph), or the
        same run eagerly."""
        loss = self.compute_loss(batch)
        (loss / accum).backward()
        return loss.detach()

    def backward(self) -> None:
        """After `step` has added loss / N into ``.grad``: apply the clipped
        optimizer update when due."""
        self._call_callbacks(event_name="on_backward_begin")
        assert self.loss is not None, "backward() needs the loss of step()"
        if self.mesh is not None:
            self.loss = self.loss.detach().clone()
            self._average_over_data([self.loss])
        self._call_callbacks(event_name="on_backward_end")

        if self.clock.is_optimizer_step:
            with span("refiners.Trainer.optimizer_step"):
                self._call_callbacks(event_name="on_optimizer_step_begin")
                params = self.learnable_parameters
                if self.mesh is not None:
                    with torch.no_grad():
                        self._average_over_data([p.grad for p in params])
                total_norm = _global_norm([p.grad for p in params])
                max_norm = self.config.training.gradient_clipping_max_norm
                if max_norm:  # None or 0: no clipping, as in the JAX package (and torch's clip_grads_with_norm_)
                    scale = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
                    with torch.no_grad():
                        torch._foreach_mul_([local(p.grad) for p in params], scale)
                with span("refiners.wait.grad_norm"):
                    self.grad_norm = float(total_norm)

                for item in self.models.values():
                    if not item.trainable:
                        continue
                    optimizer = self._optimizer_for(item)
                    optimizer.step()
                    optimizer.zero_grad(set_to_none=False)
                self._call_callbacks(event_name="on_optimizer_step_end")

                if self.clock.is_due(self.config.lr_scheduler.update_interval):
                    self._call_callbacks(event_name="on_lr_scheduler_step_begin")
                    self.lr_scheduler_step()
                    self._call_callbacks(event_name="on_lr_scheduler_step_end")

    def lr_scheduler_step(self) -> None:
        self._scheduler_steps += 1
        cfg = self.config.lr_scheduler
        if cfg.type == LRSchedulerType.REDUCE_LR_ON_PLATEAU and self.loss is not None:
            current = float(self.loss)
            p = self._plateau
            better = p["best"] is None or (
                current < p["best"] - cfg.threshold if cfg.mode == "min" else current > p["best"] + cfg.threshold
            )
            if better:
                p["best"], p["bad"] = current, 0
            elif p["cooldown"] > 0:
                p["cooldown"] -= 1
            else:
                p["bad"] += 1
                if p["bad"] > cfg.patience:
                    p["factor"] *= cfg.factor
                    p["bad"], p["cooldown"] = 0, cfg.cooldown

    def step(self, batch: Batch) -> None:
        """Single training step: the loss, its gradient / N added into
        ``.grad`` (one program under ``jit_step``), then `backward`."""
        with span("refiners.Trainer.step", id=self.clock.step):
            self._call_callbacks(event_name="on_compute_loss_begin")
            for p in self.learnable_parameters:  # the gradients' tensors, kept from step to step and zeroed in place
                if p.grad is None:  # an unused parameter keeps a zero gradient, as in the JAX package
                    p.grad = torch.zeros_like(p)
            run = self._loss_and_backward
            if self.config.training.jit_step:
                if self._step_program is None:
                    self._step_program = Program(run, name="Trainer.jit_step", mesh=self.mesh)
                run = self._step_program
            held = vars(self).values()
            modules = [m for m in held if isinstance(m, torch.nn.Module)]
            generators = [g for g in held if isinstance(g, torch.Generator)]
            accum = self.config.training.gradient_accumulation.number
            self.loss = run(modules, self.shard_batch(batch), accum, generators)
            self._call_callbacks(event_name="on_compute_loss_end")
            self.backward()

    def epoch(self) -> None:
        set_epoch = getattr(self.data_iterable, "set_epoch", None)
        if set_epoch is not None:  # a `DataLoader`: its order follows the clock, so a resumed run sees the same
            set_epoch(self.clock.epoch)
        for batch in self.data_iterable:
            if self.clock.done:
                break
            self._call_callbacks(event_name="on_step_begin")
            self.step(batch=batch)
            self._call_callbacks(event_name="on_step_end")

    @staticmethod
    def get_training_seed(instance: "Trainer[BaseConfig, Any]") -> int:
        return instance.config.training.seed

    @scoped_seed(seed=get_training_seed)
    def train(self) -> None:
        """Main training loop."""
        self._call_callbacks(event_name="on_train_begin")
        assert self.learnable_parameters, "There are no learnable parameters in the models."
        while not self.clock.done:
            self._call_callbacks(event_name="on_epoch_begin")
            self.epoch()
            self._call_callbacks(event_name="on_epoch_end")
        self._call_callbacks(event_name="on_train_end")

    # -- callbacks / loading -------------------------------------------------

    def _run_event(self, callback: Callback[Any], event_name: str) -> None:
        getattr(callback, event_name)(self)

    def _call_callbacks(self, event_name: str) -> None:
        if event_name.endswith("_begin"):
            self._run_event(self.clock, event_name)
        for callback in self.callbacks.values():
            if callback is self.clock:
                continue
            self._run_event(callback, event_name)
        if event_name.endswith("_end"):
            self._run_event(self.clock, event_name)

    def _load_callbacks(self) -> None:
        for name, config in self.config:
            if not isinstance(config, CallbackConfig):
                continue
            try:
                registered_callback = getattr(self, name)
            except AttributeError:
                raise ValueError(
                    f"Callback {name} is in the config but not registered in the Trainer. "
                    "Create a method with the @register_callback decorator."
                )
            assert callable(registered_callback)
            registered_callback(config)

    def _load_models(self) -> None:
        for name, config in self.config:
            if not isinstance(config, ModelConfig):
                continue
            try:
                registered_model = getattr(self, name)
            except AttributeError:
                raise ValueError(
                    f"Model {name} is in the config but not registered in the Trainer. "
                    "Create a method with the @register_model decorator."
                )
            assert callable(registered_model)
            registered_model(config)
