"""Latent diffusion VAE (encoder and decoder); counterpart of
``refiners_tpu/foundationals/latent_diffusion/auto_encoder.py``.

NCHW: the latent channel axis is dim 1. Tiled inference (`tiled_inference`)
encodes and decodes overlapping tiles and blends them with linear ramps;
inside it every GroupNorm is wrapped by a `FixedGroupNorm` whose statistics
are frozen from one pass over the image downscaled to a tile.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator, NamedTuple

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
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
from refiners_tpu_torch.fluxion.utils import image_to_tensor, images_to_tensor, tensor_to_image, tensor_to_images


class _ImageSize(NamedTuple):
    height: int
    width: int


class _Tile(NamedTuple):
    top: int
    left: int
    bottom: int
    right: int


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


class FixedGroupNorm(fl.Chain, Adapter[fl.GroupNorm]):
    """A GroupNorm whose statistics are frozen at its first call, so that
    every tile of a tiled pass is normalized alike. The mean and variance
    are per (batch, group), over the group's channels and space, in float32."""

    def __init__(self, target: fl.GroupNorm) -> None:
        self.mean: torch.Tensor | None = None
        self.var: torch.Tensor | None = None
        with self.setup_adapter(target):
            super().__init__(fl.Lambda(self.compute_group_norm))

    def compute_group_norm(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.target.num_groups
        xg = x.reshape(b, g, c // g, *x.shape[2:]).float()
        if self.mean is None or self.var is None:
            self.var, self.mean = torch.var_mean(xg, dim=tuple(range(2, xg.ndim)), keepdim=True, correction=0)
        y = ((xg - self.mean) * torch.rsqrt(self.var + self.target.eps)).reshape(x.shape)
        affine = (-1,) + (1,) * (x.ndim - 2)
        w, bias = self.target.weight.float().reshape(affine), self.target.bias.float().reshape(affine)
        return (y * w + bias).to(x.dtype)


def _create_blending_mask(
    size: _ImageSize,
    blending: int,
    num_channels: int,
    is_edge: tuple[bool, bool, bool, bool] = (False, False, False, False),
    device: Any = None,
) -> torch.Tensor:
    """A (1, C, H, W) float32 mask of linear ramps `blending` wide on each
    side of the tile that is not an edge (top, bottom, left, right) of the image."""
    mask = torch.ones((size.height, size.width), dtype=torch.float32, device=device)
    if blending == 0:
        return mask[None, None]
    blending = min(blending, min(size) // 2)
    ramp = torch.linspace(0, 1, blending, device=device)
    if not is_edge[0]:  # top
        mask[:blending, :] *= ramp[:, None]
    if not is_edge[1]:  # bottom
        mask[-blending:, :] *= ramp.flip(0)[:, None]
    if not is_edge[2]:  # left
        mask[:, :blending] *= ramp[None, :]
    if not is_edge[3]:  # right
        mask[:, -blending:] *= ramp.flip(0)[None, :]
    return mask[None, None].expand(1, num_channels, size.height, size.width)


class LatentDiffusionAutoencoder(Chain):
    """VAE facade with the latent scale, image↔latent helpers and tiled inference."""

    encoder_scale = 0.18125

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            Encoder(device=device, dtype=dtype),
            Decoder(device=device, dtype=dtype),
        )
        self._tile_size: _ImageSize | None = None
        self._blending: int | None = None

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

    # -- tiled inference -----------------------------------------------------

    def tiled_image_to_latents(self, image: Image.Image) -> torch.Tensor:
        if self._tile_size is None:
            raise ValueError("Tiled inference context manager not active. Use `tiled_inference` method to activate.")
        assert self._blending is not None
        image_tensor = image_to_tensor(image, device=self.device, dtype=self.dtype)
        return self._tiled_encode(2 * image_tensor - 1, self._tile_size, self._blending)

    def tiled_latents_to_image(self, x: torch.Tensor) -> Image.Image:
        if self._tile_size is None:
            raise ValueError("Tiled inference context manager not active. Use `tiled_inference` method to activate.")
        assert self._blending is not None
        result = self._tiled_decode(x, self._tile_size, self._blending)
        return tensor_to_image((result + 1) / 2)

    @staticmethod
    def _generate_latent_tiles(size: _ImageSize, tile_size: _ImageSize, overlap: int = 8) -> list[_Tile]:
        """Tiles of `tile_size` every `tile_size - overlap`, column by
        column, the last of each row and column cut at the image's edge."""
        tiles: list[_Tile] = []
        for x in range(0, max(size.width - overlap, 1), tile_size.width - overlap):
            for y in range(0, max(size.height - overlap, 1), tile_size.height - overlap):
                tiles.append(
                    _Tile(
                        top=max(0, y),
                        left=max(0, x),
                        bottom=min(size.height, y + tile_size.height),
                        right=min(size.width, x + tile_size.width),
                    )
                )
        return tiles

    def _add_fixed_group_norm(self, image: Image.Image, inference_size: _ImageSize) -> None:
        """Wrap every GroupNorm in a `FixedGroupNorm`, then freeze their
        statistics with one encode and decode of `image` downscaled to
        `inference_size`, its per-channel mean and spread matched to the
        full image's."""
        image_tensor = image_to_tensor(image, device=self.device, dtype=self.dtype)
        for group_norm, parent in list(self.walk(fl.GroupNorm)):
            FixedGroupNorm(group_norm).inject(parent)

        downscaled_image = image.resize((inference_size.width, inference_size.height))
        small = image_to_tensor(downscaled_image, device=image_tensor.device, dtype=image_tensor.dtype)
        small = torch.clamp(small, image_tensor.min(), image_tensor.max())

        dims = (0, 2, 3)  # per-channel statistics over batch and space (NCHW)
        std, mean = torch.std_mean(image_tensor, dim=dims, keepdim=True, correction=0)
        new_std, new_mean = torch.std_mean(small, dim=dims, keepdim=True, correction=0)
        small = (small - new_mean) * (std / new_std) + mean

        latents = self.encode(2 * small - 1)
        self.decode(latents)

    def _remove_fixed_group_norm(self) -> None:
        for fixed_group_norm in list(self.layers(FixedGroupNorm, recurse=True)):
            fixed_group_norm.eject()

    def _tiled_encode(self, image_tensor: torch.Tensor, tile_size: _ImageSize, blending: int = 64) -> torch.Tensor:
        latent_size = _ImageSize(height=image_tensor.shape[2] // 8, width=image_tensor.shape[3] // 8)
        target_tile = _ImageSize(height=tile_size.height // 8, width=tile_size.width // 8)
        tiles = self._generate_latent_tiles(latent_size, tile_size=target_tile, overlap=blending // 8)
        if len(tiles) == 1:
            return self.encode(image_tensor)

        device = image_tensor.device
        result = torch.zeros((1, 4, latent_size.height, latent_size.width), dtype=torch.float32, device=device)
        weights = torch.zeros_like(result)
        for t in tiles:
            pixel_tile = image_tensor[:, :, t.top * 8 : t.bottom * 8, t.left * 8 : t.right * 8]
            encoded = self.encode(pixel_tile).float()
            is_edge = (t.top == 0, t.bottom == latent_size.height, t.left == 0, t.right == latent_size.width)
            tile = _ImageSize(height=t.bottom - t.top, width=t.right - t.left)
            mask = _create_blending_mask(tile, blending // 8, 4, is_edge, device=device)
            result[:, :, t.top : t.bottom, t.left : t.right] += encoded * mask
            weights[:, :, t.top : t.bottom, t.left : t.right] += mask
        return (result / weights).to(image_tensor.dtype)

    def _tiled_decode(self, latents: torch.Tensor, tile_size: _ImageSize, blending: int = 64) -> torch.Tensor:
        latent_size = _ImageSize(height=latents.shape[2], width=latents.shape[3])
        target_tile = _ImageSize(height=tile_size.height // 8, width=tile_size.width // 8)
        tiles = self._generate_latent_tiles(latent_size, tile_size=target_tile, overlap=blending // 8)
        if len(tiles) == 1:
            return self.decode(latents)

        device = latents.device
        result = torch.zeros((1, 3, latent_size.height * 8, latent_size.width * 8), dtype=torch.float32, device=device)
        weights = torch.zeros_like(result)
        for t in tiles:
            decoded = self.decode(latents[:, :, t.top : t.bottom, t.left : t.right]).float()
            is_edge = (t.top == 0, t.bottom == latent_size.height, t.left == 0, t.right == latent_size.width)
            tile = _ImageSize(height=(t.bottom - t.top) * 8, width=(t.right - t.left) * 8)
            mask = _create_blending_mask(tile, blending, 3, is_edge, device=device)
            result[:, :, t.top * 8 : t.bottom * 8, t.left * 8 : t.right * 8] += decoded * mask
            weights[:, :, t.top * 8 : t.bottom * 8, t.left * 8 : t.right * 8] += mask
        return (result / weights).to(latents.dtype)

    @contextmanager
    def tiled_inference(
        self, image: Image.Image, tile_size: tuple[int, int] = (512, 512), blending: int = 64
    ) -> Iterator[None]:
        """Freeze the GroupNorm statistics on `image` and enable the tiled
        image↔latent methods; on exit the GroupNorms are restored."""
        try:
            self._blending = blending
            self._tile_size = _ImageSize(width=tile_size[0], height=tile_size[1])
            self._add_fixed_group_norm(image, inference_size=self._tile_size)
            yield
        finally:
            self._remove_fixed_group_norm()
            self._tile_size = None
            self._blending = None
