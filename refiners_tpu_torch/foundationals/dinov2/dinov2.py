"""DINOv2's presets and preprocessing; counterpart of
``refiners_tpu/foundationals/dinov2/dinov2.py``.

Each preset is a subclass of `ViT` with the JAX package's name and
configuration. Built with no device, a preset lands on the card
(``fluxion.utils.default_device``); CPU use passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion.layers.activations import GLU, SiLU
from refiners_tpu_torch.fluxion.utils import default_device, image_to_tensor, normalize
from refiners_tpu_torch.foundationals.dinov2.vit import ViT


def preprocess(img: Image.Image, dim: int = 224) -> torch.Tensor:
    """Resize (no center crop) and ImageNet-normalize; a (3, dim, dim) tensor."""
    img = img.convert("RGB").resize((dim, dim))
    t = image_to_tensor(img)
    return normalize(t, mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])[0]


_COMMON: dict[str, Any] = dict(patch_size=14, image_size=518)
_REG: dict[str, Any] = dict(num_registers=4, interpolate_antialias=True)
_SMALL: dict[str, Any] = dict(embedding_dim=384, num_layers=12, num_heads=6)
_BASE: dict[str, Any] = dict(embedding_dim=768, num_layers=12, num_heads=12)
_LARGE: dict[str, Any] = dict(embedding_dim=1024, num_layers=24, num_heads=16)
_GIANT: dict[str, Any] = dict(embedding_dim=1536, feedforward_dim=4096, num_layers=40, num_heads=24)


class DINOv2_small(ViT):
    """DINOv2 small: 384-dim, 12 layers, 6 heads."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_SMALL, **_COMMON, device=default_device(device), dtype=dtype)


class DINOv2_base(ViT):
    """DINOv2 base: 768-dim, 12 layers, 12 heads."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_BASE, **_COMMON, device=default_device(device), dtype=dtype)


class DINOv2_large(ViT):
    """DINOv2 large: 1024-dim, 24 layers, 16 heads."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_LARGE, **_COMMON, device=default_device(device), dtype=dtype)


class DINOv2_giant(ViT):
    """DINOv2 giant: 1536-dim, 40 layers, 24 heads, SwiGLU FFN."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_GIANT, **_COMMON, activation=GLU(SiLU()), device=default_device(device), dtype=dtype)


class DINOv2_small_reg(ViT):
    """DINOv2 small with registers."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_SMALL, **_COMMON, **_REG, device=default_device(device), dtype=dtype)


class DINOv2_base_reg(ViT):
    """DINOv2 base with registers."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_BASE, **_COMMON, **_REG, device=default_device(device), dtype=dtype)


class DINOv2_large_reg(ViT):
    """DINOv2 large with registers."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(**_LARGE, **_COMMON, **_REG, device=default_device(device), dtype=dtype)


class DINOv2_giant_reg(ViT):
    """DINOv2 giant with registers."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            **_GIANT, **_COMMON, **_REG, activation=GLU(SiLU()), device=default_device(device), dtype=dtype
        )
