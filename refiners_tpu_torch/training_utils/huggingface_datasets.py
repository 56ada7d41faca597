"""Hugging Face datasets; counterpart of
``refiners_tpu/training_utils/huggingface_datasets.py``: the protocol, the
config and `load_hf_dataset`. ``datasets`` is imported when a dataset is
loaded, never at module import; with no network, give it a local dataset
directory or data files."""

from __future__ import annotations

from typing import Any, Generic, Protocol, TypeVar

from refiners_tpu_torch.training_utils.config_base import Config

T = TypeVar("T", covariant=True)


class HuggingfaceDataset(Generic[T], Protocol):
    def __getitem__(self, index: int) -> T: ...

    def __len__(self) -> int: ...


class HuggingfaceDatasetConfig(Config):
    hf_repo: str
    revision: str = "main"
    split: str = "train"
    horizontal_flip_probability: float = 0.0
    random_crop_size: int | None = None
    resize_image_min_size: int = 512
    resize_image_max_size: int = 576
    caption_key: str = "caption"


def load_hf_dataset(path: str, revision: str = "main", split: str = "train", use_verification: bool = False) -> Any:
    import datasets  # type: ignore

    return datasets.load_dataset(path, revision=revision, split=split)  # type: ignore[no-untyped-call]
