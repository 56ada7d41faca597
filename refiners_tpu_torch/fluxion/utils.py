"""Tensor/image helpers; counterpart of the image↔tensor part of
``refiners_tpu/fluxion/utils.py``.

Images are NCHW float tensors in [0, 1] here (the JAX package's are NHWC).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from refiners_tpu_torch.fluxion.rng import manual_seed

__all__ = [
    "default_device",
    "manual_seed",
    "str_to_dtype",
    "synthesize_weights",
    "interpolate",
    "normalize",
    "pad",
    "image_to_tensor",
    "images_to_tensor",
    "tensor_to_image",
    "tensor_to_images",
]


def default_device(device: Any = None) -> torch.device:
    """The device a model facade builds on: `device` when given, else the
    card. There is no fallback to the CPU: without CUDA, building on the
    card raises, and CPU use passes ``device="cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)


def str_to_dtype(dtype: str) -> torch.dtype:
    """Map a name (as the JAX package's `str_to_dtype` takes it) to a torch dtype."""
    match dtype.lower():
        case "float32" | "float":
            return torch.float32
        case "float64" | "double":
            return torch.float64
        case "float16" | "half":
            return torch.float16
        case "bfloat16" | "bf16":
            return torch.bfloat16
        case "int32" | "int":
            return torch.int32
        case "int64" | "long":
            return torch.int64
        case "int16" | "short":
            return torch.int16
        case "int8":
            return torch.int8
        case "uint8" | "byte":
            return torch.uint8
        case "bool":
            return torch.bool
        case _:
            raise ValueError(f"Unknown dtype: {dtype}")


def synthesize_weights(module: torch.nn.Module, seed: int) -> None:
    """Seeded fan-in-scaled normals, drawn on the module's device, for every
    weight of two or more dims; norms and biases keep their constructor
    values. Stands in for real checkpoints, which the repository does not hold."""
    gen = torch.Generator(next(module.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                p.normal_(generator=gen).mul_(math.prod(p.shape[1:]) ** -0.5)


def interpolate(x: torch.Tensor, size: tuple[int, int], mode: str = "nearest", antialias: bool = False) -> torch.Tensor:
    """Resize NCHW `x` to spatial `size`. Nearest takes source index
    floor(i·in/out), as the JAX package's nearest resize does."""
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    y = F.interpolate(x.float(), size=tuple(size), mode=mode, antialias=antialias)
    return y.to(x.dtype)


def pad(x: torch.Tensor, pad: tuple[int, ...] | list[int], value: float = 0.0, mode: str = "constant") -> torch.Tensor:
    """`torch.nn.functional.pad`: pairs apply to the trailing dims, last dim first."""
    if mode == "constant":
        return F.pad(x, tuple(pad), mode=mode, value=value)
    return F.pad(x, tuple(pad), mode=mode)


def normalize(x: torch.Tensor, mean: list[float] | None = None, std: list[float] | None = None) -> torch.Tensor:
    """Per-channel (dim 1) normalization of (N, C, ...) tensors, in float32."""
    channels = x.shape[1]
    mean = [0.5] * channels if mean is None else mean
    std = [0.5] * channels if std is None else std
    assert len(mean) == len(std) == channels, "mean/std length must match channel count"
    shape = (-1,) + (1,) * (x.ndim - 2)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(shape)
    s = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(shape)
    return ((x.float() - m) / s).to(x.dtype)


def image_to_tensor(image: Image.Image, device: Any = None, dtype: Any = None) -> torch.Tensor:
    """PIL → (1, C, H, W) float in [0, 1]; 8-bit grayscale stays 1-channel and
    1-bit images are thresholded."""
    arr = np.asarray(image)
    if image.mode == "1":
        arr = arr.astype(np.float32)
    elif image.mode == "I":
        arr = arr.astype(np.float32) / (2**32 - 1)
    else:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    t = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)[None]))
    return t.to(device=device, dtype=dtype or torch.float32)


def images_to_tensor(images: list[Image.Image], device: Any = None, dtype: Any = None) -> torch.Tensor:
    return torch.cat([image_to_tensor(im, device=device, dtype=dtype) for im in images], dim=0)


def tensor_to_image(tensor: torch.Tensor) -> Image.Image:
    """(1, C, H, W) or (C, H, W) float in [0, 1] → PIL."""
    if tensor.ndim == 4:
        assert tensor.shape[0] == 1, "batched tensors use tensor_to_images"
        tensor = tensor[0]
    arr = tensor.detach().float().clamp(0.0, 1.0).permute(1, 2, 0).cpu().numpy()
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    return Image.fromarray((arr * 255).round().astype(np.uint8))


def tensor_to_images(tensor: torch.Tensor) -> list[Image.Image]:
    return [tensor_to_image(t) for t in tensor]
