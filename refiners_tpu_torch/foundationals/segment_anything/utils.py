"""SAM pre/post-processing; counterpart of
``refiners_tpu/foundationals/segment_anything/utils.py``.

Images are NCHW here (the JAX package's are NHWC); masks keep the public
(N, M, H, W) layout of both packages.
"""

from __future__ import annotations

from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion.utils import image_to_tensor, interpolate, normalize, pad

# SAM's per-channel pixel statistics, for images in [0, 255]
PIXEL_MEAN = [123.675, 116.28, 103.53]
PIXEL_STD = [58.395, 57.12, 57.375]


def compute_scaled_size(size: tuple[int, int], image_encoder_resolution: int) -> tuple[int, int]:
    """(height, width) scaled to fit the encoder square, aspect preserved."""
    oldh, oldw = size
    scale = image_encoder_resolution * 1.0 / max(oldh, oldw)
    newh, neww = oldh * scale, oldw * scale
    return (int(newh + 0.5), int(neww + 0.5))


def image_to_scaled_tensor(
    image: Image.Image, scaled_size: tuple[int, int], device: Any = None, dtype: Any = None
) -> torch.Tensor:
    """(1, C, h, w) tensor in [0, 255]."""
    h, w = scaled_size
    resized = image.resize((w, h), resample=Image.Resampling.BILINEAR)
    return image_to_tensor(resized, device=device, dtype=dtype) * 255.0


def preprocess_image(
    image: Image.Image, image_encoder_resolution: int, device: Any = None, dtype: Any = None
) -> torch.Tensor:
    """Resize the long side to the encoder resolution, normalize, zero-pad square."""
    scaled_size = compute_scaled_size((image.height, image.width), image_encoder_resolution)
    image_tensor = image_to_scaled_tensor(image, scaled_size, device=device, dtype=dtype)
    return pad_image_tensor(
        normalize(image_tensor, mean=PIXEL_MEAN, std=PIXEL_STD), scaled_size, image_encoder_resolution
    )


def pad_image_tensor(
    image_tensor: torch.Tensor, scaled_size: tuple[int, int], image_encoder_resolution: int
) -> torch.Tensor:
    """Zero-pad an (N, C, h, w) tensor on the bottom and right to the encoder square."""
    assert image_tensor.ndim == 4
    assert image_tensor.shape[2] <= image_encoder_resolution  # H
    assert image_tensor.shape[3] <= image_encoder_resolution  # W
    h, w = scaled_size
    return pad(image_tensor, (0, image_encoder_resolution - w, 0, image_encoder_resolution - h))


def postprocess_masks(
    low_res_masks: torch.Tensor, original_size: tuple[int, int], image_encoder_resolution: int
) -> torch.Tensor:
    """(N, M, 256, 256) → (N, M, H, W): upsample to the encoder square, crop the
    padding, resize to the original size (bilinear, half-pixel centers, no
    antialiasing, as the JAX package's `jax.image.resize`)."""
    scaled_size = compute_scaled_size(original_size, image_encoder_resolution)
    masks = interpolate(low_res_masks, (image_encoder_resolution, image_encoder_resolution), mode="bilinear")
    masks = masks[:, :, : scaled_size[0], : scaled_size[1]]  # remove the preprocessing padding
    return interpolate(masks, original_size, mode="bilinear")


def normalize_coordinates(
    coordinates: torch.Tensor, original_size: tuple[int, int], image_encoder_resolution: int
) -> torch.Tensor:
    """Pixel (x, y) coordinates (N, P, 2) → [0, 1] encoder space."""
    scaled_size = compute_scaled_size(original_size, image_encoder_resolution)
    x = ((coordinates[:, :, 0] * (scaled_size[1] / original_size[1])) + 0.5) / image_encoder_resolution
    y = ((coordinates[:, :, 1] * (scaled_size[0] / original_size[0])) + 0.5) / image_encoder_resolution
    return torch.stack([x, y], dim=-1)
