"""Latent diffusion VAE (encoder and decoder); counterpart of
``refiners_tpu/foundationals/latent_diffusion/auto_encoder.py``.

NCHW: the latent channel axis is dim 1. Tiled inference and FixedGroupNorm
are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.layers import (
    Chain,
    Conv2d,
    Downsample,
    GroupNorm,
    Identity,
    Residual,
    SelfAttention2d,
    SiLU,
    Slicing,
    Sum,
    Upsample,
)
from refiners_tpu_torch.fluxion.utils import images_to_tensor, tensor_to_images


class Resnet(Sum):
    """Shortcut + (GN → SiLU → Conv, twice)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_groups: int = 32,
        device: Any = None,
        dtype: Any = None,
    ):
        self.in_channels = in_channels
        self.out_channels = out_channels
        shortcut = (
            Conv2d(in_channels=in_channels, out_channels=out_channels, kernel_size=1, device=device, dtype=dtype)
            if in_channels != out_channels
            else Identity()
        )
        super().__init__(
            shortcut,
            Chain(
                GroupNorm(channels=in_channels, num_groups=num_groups, device=device, dtype=dtype),
                SiLU(),
                Conv2d(in_channels=in_channels, out_channels=out_channels, kernel_size=3, padding=1, device=device, dtype=dtype),
                GroupNorm(channels=out_channels, num_groups=num_groups, device=device, dtype=dtype),
                SiLU(),
                Conv2d(in_channels=out_channels, out_channels=out_channels, kernel_size=3, padding=1, device=device, dtype=dtype),
            ),
        )


class Encoder(Chain):
    """128→512 resnets, mid self-attention, 2×4 latent channels; the logvar
    half is dropped by the trailing Slicing."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        resnet_sizes: list[int] = [128, 256, 512, 512, 512]
        input_channels: int = 3
        latent_dim: int = 8
        resnet_layers: list[Chain] = [
            Chain(
                [
                    Resnet(
                        in_channels=resnet_sizes[i - 1] if i > 0 else resnet_sizes[0],
                        out_channels=resnet_sizes[i],
                        device=device,
                        dtype=dtype,
                    ),
                    Resnet(in_channels=resnet_sizes[i], out_channels=resnet_sizes[i], device=device, dtype=dtype),
                ]
            )
            for i in range(len(resnet_sizes))
        ]
        for _, layer in zip(range(3), resnet_layers):
            channels: int = layer[-1].out_channels
            layer.append(Downsample(channels=channels, scale_factor=2, device=device, dtype=dtype))

        attention_layer = Residual(
            GroupNorm(channels=resnet_sizes[-1], num_groups=32, eps=1e-6, device=device, dtype=dtype),
            SelfAttention2d(channels=resnet_sizes[-1], device=device, dtype=dtype),
        )
        resnet_layers[-1].insert_after_type(Resnet, attention_layer)
        super().__init__(
            Conv2d(in_channels=input_channels, out_channels=resnet_sizes[0], kernel_size=3, padding=1, device=device, dtype=dtype),
            Chain(*resnet_layers),
            Chain(
                GroupNorm(channels=resnet_sizes[-1], num_groups=32, eps=1e-6, device=device, dtype=dtype),
                SiLU(),
                Conv2d(in_channels=resnet_sizes[-1], out_channels=latent_dim, kernel_size=3, padding=1, device=device, dtype=dtype),
            ),
            Chain(
                Conv2d(in_channels=8, out_channels=8, kernel_size=1, device=device, dtype=dtype),
                Slicing(dim=1, end=4),  # drop the logvar half (NCHW: channels at dim 1)
            ),
        )

    def init_context(self) -> Contexts:
        return {"sampling": {"shapes": []}}


class Decoder(Chain):
    """Mirror of the encoder."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        self.resnet_sizes: list[int] = [128, 256, 512, 512, 512]
        self.latent_dim: int = 4
        self.output_channels: int = 3
        resnet_sizes = self.resnet_sizes[::-1]
        resnet_layers: list[Chain] = [
            Chain(
                [
                    Resnet(
                        in_channels=resnet_sizes[i - 1] if i > 0 else resnet_sizes[0],
                        out_channels=resnet_sizes[i],
                        device=device,
                        dtype=dtype,
                    ),
                    Resnet(in_channels=resnet_sizes[i], out_channels=resnet_sizes[i], device=device, dtype=dtype),
                ]
                + (
                    [Resnet(in_channels=resnet_sizes[i], out_channels=resnet_sizes[i], device=device, dtype=dtype)]
                    if i > 0
                    else []
                )
            )
            for i in range(len(resnet_sizes))
        ]
        attention_layer = Residual(
            GroupNorm(channels=resnet_sizes[0], num_groups=32, eps=1e-6, device=device, dtype=dtype),
            SelfAttention2d(channels=resnet_sizes[0], device=device, dtype=dtype),
        )
        resnet_layers[0].insert(1, attention_layer)
        for _, layer in zip(range(3), resnet_layers[1:]):
            channels: int = layer.layer(-1, Resnet).out_channels
            layer.insert(-1, Upsample(channels=channels, upsample_factor=2, device=device, dtype=dtype))
        super().__init__(
            Conv2d(in_channels=self.latent_dim, out_channels=self.latent_dim, kernel_size=1, device=device, dtype=dtype),
            Conv2d(in_channels=self.latent_dim, out_channels=resnet_sizes[0], kernel_size=3, padding=1, device=device, dtype=dtype),
            Chain(*resnet_layers),
            Chain(
                GroupNorm(channels=resnet_sizes[-1], num_groups=32, eps=1e-6, device=device, dtype=dtype),
                SiLU(),
                Conv2d(in_channels=resnet_sizes[-1], out_channels=self.output_channels, kernel_size=3, padding=1, device=device, dtype=dtype),
            ),
        )


class LatentDiffusionAutoencoder(Chain):
    """VAE facade with the latent scale and image↔latent helpers."""

    encoder_scale = 0.18125

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            Encoder(device=device, dtype=dtype),
            Decoder(device=device, dtype=dtype),
        )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder_scale * self[0](x)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](x / self.encoder_scale)

    def image_to_latents(self, image: Image.Image) -> torch.Tensor:
        return self.images_to_latents([image])

    def images_to_latents(self, images: list[Image.Image]) -> torch.Tensor:
        x = images_to_tensor(images, device=self.device, dtype=self.dtype)
        return self.encode(2 * x - 1)

    def latents_to_image(self, x: torch.Tensor) -> Image.Image:
        if x.shape[0] != 1:
            raise ValueError(f"Expected batch size of 1, got {x.shape[0]}")
        return self.latents_to_images(x)[0]

    def latents_to_images(self, x: torch.Tensor) -> list[Image.Image]:
        return tensor_to_images((self.decode(x) + 1) / 2)
