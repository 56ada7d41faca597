"""Data loading; counterpart of ``refiners_tpu/training_utils/data_loader.py``.

The same config (fields, defaults and both validators), `DatasetFromCallable`
and `create_data_loader`, and the JAX package's collate rule: with no
`collate_fn`, a batch of one yields the item and a larger batch the list of
items. `DataLoader` is a `torch.utils.data.DataLoader`, so ``num_workers``,
``pin_memory``, ``prefetch_factor`` and ``persistent_workers`` take effect.

Shuffling draws each epoch's order from a `torch.Generator` seeded with
``seed + epoch`` (the trainer passes its training seed; `Trainer.epoch`
calls `set_epoch` with its clock's epoch), so the order is a function of the
seed and the epoch alone: a run resumed from a checkpoint sees the batches
the uninterrupted run saw. The global random state is never drawn from.
"""

from __future__ import annotations

from typing import Any, Callable, Generic, Iterator, TypeVar

import torch

from refiners_tpu_torch.training_utils.config_base import Config

BatchT = TypeVar("BatchT")


class DataLoaderConfig(Config):
    batch_size: int = 1
    num_workers: int = 0
    pin_memory: bool = False
    prefetch_factor: int | None = None
    persistent_workers: bool = False
    drop_last: bool = False
    shuffle: bool = True

    def __post_init__(self) -> None:
        super().__post_init__()
        # pydantic's PositiveInt / NonNegativeInt in the JAX package
        if self.batch_size <= 0:
            raise ValueError(f"batch_size={self.batch_size} must be positive")
        if self.num_workers < 0:
            raise ValueError(f"num_workers={self.num_workers} must be non-negative")
        if self.prefetch_factor is not None and self.prefetch_factor <= 0:
            raise ValueError(f"prefetch_factor={self.prefetch_factor} must be positive")
        if self.prefetch_factor is not None and self.num_workers == 0:
            raise ValueError(f"prefetch_factor={self.prefetch_factor} requires num_workers > 0")
        if self.num_workers == 0 and self.persistent_workers is True:
            raise ValueError(f"persistent_workers={self.persistent_workers} option needs num_workers > 0")


class DatasetFromCallable(torch.utils.data.Dataset[BatchT], Generic[BatchT]):
    """Wrap a `get_item` callable as a sized dataset."""

    def __init__(self, get_item: Callable[[int], BatchT], length: int) -> None:
        assert length > 0, "Dataset length must be greater than 0."
        self.length = length
        self.get_item = get_item

    def __getitem__(self, index: int) -> BatchT:
        return self.get_item(index)

    def __len__(self) -> int:
        return self.length


def _first(items: list[Any]) -> Any:
    return items[0]


def _as_list(items: list[Any]) -> list[Any]:
    return items


class _EpochSampler(torch.utils.data.Sampler[int]):
    """Indices in order, or shuffled by a generator seeded with seed + epoch."""

    def __init__(self, length: int, shuffle: bool, seed: int) -> None:
        self.length, self.shuffle, self.seed = length, shuffle, seed
        self.epoch = 0

    def __iter__(self) -> Iterator[int]:
        if not self.shuffle:
            return iter(range(self.length))
        generator = torch.Generator().manual_seed(self.seed + self.epoch)
        return iter(torch.randperm(self.length, generator=generator).tolist())

    def __len__(self) -> int:
        return self.length


class DataLoader(torch.utils.data.DataLoader[BatchT], Generic[BatchT]):
    def __init__(
        self,
        dataset: DatasetFromCallable[BatchT],
        config: DataLoaderConfig,
        collate_fn: Callable[[list[BatchT]], BatchT] | None = None,
        seed: int = 0,
    ) -> None:
        if collate_fn is None:
            collate_fn = _first if config.batch_size == 1 else _as_list  # type: ignore[assignment]
        super().__init__(
            dataset,
            batch_size=config.batch_size,
            sampler=_EpochSampler(len(dataset), config.shuffle, seed),
            num_workers=config.num_workers,
            collate_fn=collate_fn,
            pin_memory=config.pin_memory,
            drop_last=config.drop_last,
            prefetch_factor=config.prefetch_factor,
            persistent_workers=config.persistent_workers,
            # the workers' base seed, drawn once an epoch: from here, not from the global state
            generator=torch.Generator().manual_seed(seed),
        )
        self.config = config

    def set_epoch(self, epoch: int) -> None:
        """Shuffle the next pass as epoch `epoch` (seed + epoch)."""
        self.sampler.epoch = epoch  # type: ignore[attr-defined]


def create_data_loader(
    get_item: Callable[[int], BatchT],
    length: int,
    config: DataLoaderConfig,
    collate_fn: Callable[[list[BatchT]], BatchT] | None = None,
    seed: int = 0,
) -> DataLoader[BatchT]:
    return DataLoader(DatasetFromCallable(get_item, length), config, collate_fn=collate_fn, seed=seed)
