"""Tensor/image helpers and safetensors I/O; counterpart of
``refiners_tpu/fluxion/utils.py``.

Images are NCHW float tensors in [0, 1] here (the JAX package's are NHWC).
`safetensors` is imported only by the functions that read or write its files.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from refiners_tpu_torch.fluxion.rng import manual_seed

__all__ = [
    "default_device",
    "norm",
    "manual_seed",
    "no_grad",
    "str_to_dtype",
    "synthesize_weights",
    "interpolate",
    "normalize",
    "gaussian_blur",
    "pad",
    "image_to_tensor",
    "images_to_tensor",
    "tensor_to_image",
    "tensor_to_images",
    "load_tensors",
    "load_from_safetensors",
    "save_to_safetensors",
    "safe_open",
    "summarize_tensor",
    "device_has_bfloat16",
]


def default_device(device: Any = None) -> torch.device:
    """The device a model facade builds on: `device` when given, else the
    card. There is no fallback to the CPU: without CUDA, building on the
    card raises, and CPU use passes ``device="cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)


def norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of `x` flattened."""
    return torch.linalg.norm(x)


def no_grad() -> torch.no_grad:
    return torch.no_grad()


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


def gaussian_blur(
    x: torch.Tensor, kernel_size: int | tuple[int, int], sigma: float | tuple[float, float] | None = None
) -> torch.Tensor:
    """Depthwise gaussian blur of NCHW `x`, as torchvision's: reflect padding,
    then a separable convolution in float32; sigma defaults from the size."""
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    if sigma is None:
        sh, sw = 0.3 * ((kh - 1) * 0.5 - 1) + 0.8, 0.3 * ((kw - 1) * 0.5 - 1) + 0.8
    else:
        sh, sw = (sigma, sigma) if isinstance(sigma, (int, float)) else sigma

    def kernel1d(k: int, s: float) -> torch.Tensor:
        r = torch.arange(k, dtype=torch.float32, device=x.device) - (k - 1) / 2
        g = torch.exp(-(r**2) / (2 * s * s))
        return g / g.sum()

    c = x.shape[1]
    y = F.pad(x.float(), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2), mode="reflect")
    y = F.conv2d(y, kernel1d(kh, sh).reshape(1, 1, kh, 1).expand(c, 1, kh, 1), groups=c)
    y = F.conv2d(y, kernel1d(kw, sw).reshape(1, 1, 1, kw).expand(c, 1, 1, kw), groups=c)
    return y.to(x.dtype)


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


def load_tensors(path: Path | str, device: Any = "cpu") -> dict[str, Any]:
    """Load a torch .pt/.bin checkpoint (tensors only, nested dicts kept, as
    textual-inversion embeddings ship: ``{"string_to_param": {"*": tensor}}``)."""
    return torch.load(path, map_location=device, weights_only=True)  # type: ignore[no-any-return]


def load_from_safetensors(path: Path | str, device: Any = "cpu") -> dict[str, torch.Tensor]:
    """A safetensors file as a flat dict of tensors on `device`."""
    from safetensors.torch import load_file

    return load_file(str(path), device=str(device))


def safe_open(path: Path | str, framework: str = "pt", device: str = "cpu") -> Any:
    from safetensors import safe_open as _safe_open

    return _safe_open(str(path), framework=framework, device=device)  # type: ignore[no-untyped-call]


def save_to_safetensors(
    path: Path | str, tensors: dict[str, torch.Tensor], metadata: dict[str, str] | None = None
) -> None:
    """Save a flat dict of tensors (contiguous host copies) to safetensors."""
    from safetensors.torch import save_file

    save_file({k: v.detach().contiguous().cpu() for k, v in tensors.items()}, str(path), metadata=metadata)


def summarize_tensor(tensor: torch.Tensor, /) -> str:
    """One-line summary: shape, dtype and, when not empty, min, max, mean,
    std (population), norm and whether it requires a gradient."""
    info = [f"shape=({', '.join(map(str, tensor.shape))})", f"dtype={str(tensor.dtype).removeprefix('torch.')}"]
    if tensor.numel() > 0:
        t = tensor.detach().float()
        info += [
            f"min={float(t.min()):.2f}",
            f"max={float(t.max()):.2f}",
            f"mean={float(t.mean()):.2f}",
            f"std={float(t.std(correction=0)):.2f}",
            f"norm={float(torch.linalg.norm(t)):.2f}",
            f"grad={tensor.requires_grad}",
        ]
    return "Tensor(" + ", ".join(info) + ")"


def device_has_bfloat16(device: Any = None) -> bool:
    """Whether `device` (the card by default) computes in bfloat16."""
    device = default_device(device)
    if device.type == "cuda":
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()
    return True
