"""DINOv2-based Fréchet distance; counterpart of
``refiners_tpu/training_utils/metrics.py``.

Representations are the class tokens of a DINOv2 model at 224² (257 tokens:
the plain attention path), taken in float64 on the host; the distance is
numpy, as in the JAX package. The forward is a compiled program
(`fluxion.graphs.Program`) for the call's batches, as the JAX package jits
it: a CUDA graph on the card, eager on the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable, Protocol

import numpy as np
import torch
from PIL import Image

from refiners_tpu_torch.fluxion.graphs import Program
from refiners_tpu_torch.foundationals import dinov2


class _Sized(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, i: int) -> Any: ...


def get_dinov2_representations(model: dinov2.ViT, batches: Iterable[torch.Tensor]) -> np.ndarray:
    """Class-token embeddings of every (B, 3, 224, 224) batch, as float64."""
    reps: list[np.ndarray] = []
    run = Program(lambda m, x: m(x)[:, 0], name="get_dinov2_representations")
    for batch in batches:
        batch_size = batch.shape[0]
        assert batch.shape == (batch_size, 3, 224, 224), f"expected NCHW 224² batches, got {tuple(batch.shape)}"
        with torch.inference_mode():
            pred = run(model, batch.to(device=model.device, dtype=model.dtype))
        assert pred.shape == (batch_size, model.embedding_dim)
        reps.append(pred.double().cpu().numpy())
    return np.concatenate(reps)


def frechet_distance(reps_a: np.ndarray, reps_b: np.ndarray) -> float:
    """Fréchet distance between two sets of representations, (batch, N) each."""
    assert reps_a.ndim == 2 and reps_b.ndim == 2, "representations must have shape (batch, N)"
    assert reps_a.shape[1] == reps_b.shape[1], "representations must have the same dimension"

    mean_a = reps_a.mean(axis=0)
    cov_a = np.cov(reps_a.T)
    mean_b = reps_b.mean(axis=0)
    cov_b = np.cov(reps_b.T)

    # tr(sqrt(A·B)) = sum of square roots of eigenvalues of A·B
    trace = np.real(np.linalg.eigvals(cov_a @ cov_b) ** 0.5).sum()
    return float(((mean_a - mean_b) ** 2).sum() + np.trace(cov_a) + np.trace(cov_b) - 2 * trace)


class DinoDataset:
    """The PNG images of a directory, sorted by name, each preprocessed."""

    def __init__(self, path: str | Path) -> None:
        self.image_paths = sorted(Path(path).glob("*.png"))

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> torch.Tensor:
        return dinov2.preprocess(Image.open(self.image_paths[i]))


def _batched(dataset: _Sized, batch_size: int) -> Iterable[torch.Tensor]:
    for i in range(0, len(dataset), batch_size):
        yield torch.stack([dataset[j] for j in range(i, min(i + batch_size, len(dataset)))])


def dinov2_frechet_distance(
    dataset_a: _Sized | str | Path,
    dataset_b: _Sized | str | Path,
    model: dinov2.ViT,
    batch_size: int = 64,
) -> float:
    """DINOv2 Fréchet distance between two datasets (or directories of PNGs)."""
    if isinstance(dataset_a, (str, Path)):
        dataset_a = DinoDataset(dataset_a)
    if isinstance(dataset_b, (str, Path)):
        dataset_b = DinoDataset(dataset_b)
    reps_a = get_dinov2_representations(model, _batched(dataset_a, batch_size))
    reps_b = get_dinov2_representations(model, _batched(dataset_b, batch_size))
    return frechet_distance(reps_a, reps_b)
