"""Seeded generators for parameter initialization and sampling.

Counterpart of ``refiners_tpu/fluxion/rng.py``. The JAX package bridges its
explicit keys with a module-level stream so that constructors keep the
reference signatures (no ``key`` argument); here the stream is one
``torch.Generator`` per device, all seeded by ``manual_seed``. A generator
lives on the device it draws for, so a model built on the card is
initialized there without a host round trip.
"""

from __future__ import annotations

from typing import Any

import torch

_seed = 0
_generators: dict[torch.device, torch.Generator] = {}


def manual_seed(seed: int) -> None:
    """Reseed every device's init/sampling generator."""
    global _seed
    _seed = seed
    _generators.clear()


def generator(device: Any = None) -> torch.Generator:
    """The seeded generator of ``device`` (CPU by default)."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _generators:
        _generators[device] = torch.Generator(device=device).manual_seed(_seed)
    return _generators[device]


def init_uniform(shape: tuple[int, ...], bound: float, device: Any = None, dtype: Any = None) -> torch.nn.Parameter:
    """U(-bound, bound) parameter; left uninitialized on the meta device."""
    w = torch.empty(shape, device=device, dtype=dtype or torch.float32)
    if w.device.type != "meta":
        w.uniform_(-bound, bound, generator=generator(w.device))
    return torch.nn.Parameter(w)


def init_normal(shape: tuple[int, ...], std: float = 1.0, device: Any = None, dtype: Any = None) -> torch.nn.Parameter:
    w = torch.empty(shape, device=device, dtype=dtype or torch.float32)
    if w.device.type != "meta":
        w.normal_(0.0, std, generator=generator(w.device))
    return torch.nn.Parameter(w)


def ones(shape: tuple[int, ...], device: Any = None, dtype: Any = None) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.ones(shape, device=device, dtype=dtype or torch.float32))


def zeros(shape: tuple[int, ...], device: Any = None, dtype: Any = None) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.zeros(shape, device=device, dtype=dtype or torch.float32))
