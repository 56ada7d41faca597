"""MultiDiffusion (arXiv:2302.08113): diffusion over overlapping tiles with a
weighted merge; counterpart of
``refiners_tpu/foundationals/latent_diffusion/multi_diffusion.py``.

NCHW: a tile crops and pastes dims 2 and 3 of the latents.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Generic, NamedTuple, Sequence, TypeVar

import torch

from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import Solver

MAX_STEPS = 1000


class Tile(NamedTuple):
    top: int
    left: int
    bottom: int
    right: int


class Size(NamedTuple):
    height: int
    width: int


@dataclass(kw_only=True)
class DiffusionTarget:
    """One tile to diffuse: its own solver (a multistep solver's history is
    the tile's), optional init latents, opacity mask (1, 1, h, w), weight and
    step range."""

    tile: Tile
    solver: Solver
    init_latents: torch.Tensor | None = None
    opacity_mask: torch.Tensor | None = None
    weight: int = 1
    start_step: int = 0
    end_step: int = MAX_STEPS

    @property
    def size(self) -> Size:
        return Size(height=self.tile.bottom - self.tile.top, width=self.tile.right - self.tile.left)

    @property
    def offset(self) -> tuple[int, int]:
        return self.tile.top, self.tile.left

    def crop(self, tensor: torch.Tensor, /) -> torch.Tensor:
        height, width = self.size
        top, left = self.offset
        return tensor[:, :, top : top + height, left : left + width]

    def paste(self, tensor: torch.Tensor, /, crop: torch.Tensor) -> torch.Tensor:
        """A copy of `tensor` with the tile's region replaced by `crop`."""
        height, width = self.size
        top, left = self.offset
        out = tensor.clone()
        out[:, :, top : top + height, left : left + width] = crop
        return out


T = TypeVar("T", bound=DiffusionTarget)


class MultiDiffusion(ABC, Generic[T]):
    """Each target diffused on its crop, then the crops averaged by weight
    where they overlap; pixels no target covers keep `x`."""

    def __call__(self, x: torch.Tensor, /, noise: torch.Tensor, step: int, targets: Sequence[T]) -> torch.Tensor:
        num_updates = torch.zeros_like(x)
        cumulative_values = torch.zeros_like(x)

        for target in targets:
            match step:
                case step if step == target.start_step and target.init_latents is not None:
                    noise_view = target.crop(noise)
                    view = target.solver.add_noise(target.init_latents, noise_view, step)
                case step if target.start_step <= step <= target.end_step:
                    view = target.crop(x)
                case _:
                    continue
            view = self.diffuse_target(x=view, step=step, target=target)
            weight = target.weight * target.opacity_mask if target.opacity_mask is not None else target.weight
            num_updates = target.paste(num_updates, crop=target.crop(num_updates) + weight)
            cumulative_values = target.paste(cumulative_values, crop=target.crop(cumulative_values) + weight * view)

        return torch.where(num_updates > 0, cumulative_values / torch.clamp(num_updates, min=1e-12), x)

    @abstractmethod
    def diffuse_target(self, x: torch.Tensor, step: int, target: T) -> torch.Tensor: ...

    @staticmethod
    def generate_latent_tiles(size: Size, tile_size: Size, min_overlap: int = 8) -> list[Tile]:
        """Cover `size` with full-size tiles spread evenly, each pair of
        neighbours overlapping by at least `min_overlap`."""
        assert (
            0 <= min_overlap < min(tile_size.height, tile_size.width)
        ), "Overlap must be non-negative and less than the tile size"

        if tile_size.width > size.width or tile_size.height > size.height:
            return [Tile(top=0, left=0, bottom=size.height, right=size.width)]

        def plan(length: int, tile_length: int) -> tuple[int, int]:
            if tile_length >= length:
                return 1, 0
            num = math.ceil((length - tile_length) / (tile_length - min_overlap)) + 1
            overlap = (num * tile_length - length) // (num - 1)
            return num, overlap

        num_x, overlap_x = plan(size.width, tile_size.width)
        num_y, overlap_y = plan(size.height, tile_size.height)

        tiles: list[Tile] = []
        for i in range(num_y):
            for j in range(num_x):
                x = min(j * (tile_size.width - overlap_x), size.width - tile_size.width)
                y = min(i * (tile_size.height - overlap_y), size.height - tile_size.height)
                tiles.append(Tile(top=y, left=x, bottom=y + tile_size.height, right=x + tile_size.width))
        return tiles
