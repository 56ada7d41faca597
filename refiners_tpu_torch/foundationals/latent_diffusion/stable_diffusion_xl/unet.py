"""Stable Diffusion XL U-Net (arXiv:2307.01952); counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/unet.py``.
2048-dim text context, linear-projection transformer blocks ×2/×10, 10 skip
residuals, pooled-text + time-ids micro-conditioning."""

from __future__ import annotations

from typing import Any, cast

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock2d
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import (
    RangeAdapter2d,
    RangeEncoder,
    compute_sinusoidal_embedding,
)
from refiners_tpu_torch.foundationals.latent_diffusion.unet import (
    ResidualAccumulator,
    ResidualBlock,
    ResidualConcatenator,
)


class TextTimeEmbedding(fl.Chain):
    """Pooled text embedding + sinusoidal time ids → timestep embedding.

    `timestep_embedding_dim` scales with the UNet width (4·base_channels);
    the pooled-embedding (1280) and time-ids (256) input dims stay fixed."""

    def __init__(self, timestep_embedding_dim: int = 1280, device: Any = None, dtype: Any = None) -> None:
        self.timestep_embedding_dim = timestep_embedding_dim
        self.time_ids_embedding_dim = 256
        self.text_time_embedding_dim = 2816
        super().__init__(
            fl.Concatenate(
                fl.UseContext(context="diffusion", key="pooled_text_embedding"),
                fl.Chain(
                    fl.UseContext(context="diffusion", key="time_ids"),
                    fl.Unsqueeze(dim=-1),
                    fl.Lambda(func=self.compute_sinusoidal_embedding),
                    fl.Reshape(-1),
                ),
                dim=1,
            ),
            fl.Converter(set_device=False, set_dtype=True),
            fl.Linear(
                in_features=self.text_time_embedding_dim,
                out_features=self.timestep_embedding_dim,
                device=device,
                dtype=dtype,
            ),
            fl.SiLU(),
            fl.Linear(
                in_features=self.timestep_embedding_dim,
                out_features=self.timestep_embedding_dim,
                device=device,
                dtype=dtype,
            ),
        )

    def compute_sinusoidal_embedding(self, x: torch.Tensor) -> torch.Tensor:
        return compute_sinusoidal_embedding(x, embedding_dim=self.time_ids_embedding_dim)


class TimestepEncoder(fl.Passthrough):
    """Sum of the timestep RangeEncoder and TextTimeEmbedding."""

    def __init__(
        self,
        context_key: str = "timestep_embedding",
        base_channels: int = 320,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.timestep_embedding_dim = 4 * base_channels
        super().__init__(
            fl.Sum(
                fl.Chain(
                    fl.UseContext(context="diffusion", key="timestep"),
                    RangeEncoder(
                        sinusoidal_embedding_dim=base_channels,
                        embedding_dim=self.timestep_embedding_dim,
                        device=device,
                        dtype=dtype,
                    ),
                ),
                TextTimeEmbedding(timestep_embedding_dim=self.timestep_embedding_dim, device=device, dtype=dtype),
            ),
            fl.SetContext(context="range_adapter", key=context_key),
        )


class SDXLCrossAttention(CrossAttentionBlock2d):
    """2048-dim text context, linear projection."""

    def __init__(
        self,
        channels: int,
        num_attention_layers: int = 1,
        num_attention_heads: int = 10,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            channels=channels,
            context_embedding_dim=2048,
            context_key="clip_text_embedding",
            num_attention_layers=num_attention_layers,
            num_attention_heads=num_attention_heads,
            use_bias=False,
            use_linear_projection=True,
            device=device,
            dtype=dtype,
        )


def _block(
    in_ch: int,
    out_ch: int,
    attn: tuple[int, int] | None,  # (num_layers, num_heads)
    device: Any,
    dtype: Any,
    tail: fl.Module | None = None,
) -> fl.Chain:
    layers: list[fl.Module] = [ResidualBlock(in_channels=in_ch, out_channels=out_ch, device=device, dtype=dtype)]
    if attn is not None:
        layers.append(
            SDXLCrossAttention(
                channels=out_ch, num_attention_layers=attn[0], num_attention_heads=attn[1], device=device, dtype=dtype
            )
        )
    if tail is not None:
        layers.append(tail)
    return fl.Chain(*layers)


def _heads(channels: int) -> int:
    """SDXL's head count is channels/64 (640→10, 1280→20); the same rule keeps
    reduced-width builds valid (head_dim stays 64 or the width itself)."""
    return max(1, channels // 64)


class DownBlocks(fl.Chain):
    """Conv-in, 2 plain blocks, 2×(2c, 2-layer attention), 2×(4c, 10-layer
    attention), downsamples between stages."""

    def __init__(self, in_channels: int, base_channels: int = 320, device: Any = None, dtype: Any = None) -> None:
        self.in_channels = in_channels
        c1, c2, c4 = base_channels, 2 * base_channels, 4 * base_channels

        def down(c: int) -> fl.Chain:
            return fl.Chain(fl.Downsample(channels=c, scale_factor=2, padding=1, device=device, dtype=dtype))

        super().__init__(
            fl.Chain(
                fl.Conv2d(in_channels=in_channels, out_channels=c1, kernel_size=3, padding=1, device=device, dtype=dtype)
            ),
            _block(c1, c1, None, device, dtype),
            _block(c1, c1, None, device, dtype),
            down(c1),
            _block(c1, c2, (2, _heads(c2)), device, dtype),
            _block(c2, c2, (2, _heads(c2)), device, dtype),
            down(c2),
            _block(c2, c4, (10, _heads(c4)), device, dtype),
            _block(c4, c4, (10, _heads(c4)), device, dtype),
        )


class UpBlocks(fl.Chain):
    def __init__(self, base_channels: int = 320, device: Any = None, dtype: Any = None) -> None:
        c1, c2, c4 = base_channels, 2 * base_channels, 4 * base_channels

        def up(c: int) -> fl.Upsample:
            return fl.Upsample(channels=c, device=device, dtype=dtype)

        super().__init__(
            _block(2 * c4, c4, (10, _heads(c4)), device, dtype),
            _block(2 * c4, c4, (10, _heads(c4)), device, dtype),
            _block(c4 + c2, c4, (10, _heads(c4)), device, dtype, tail=up(c4)),
            _block(c4 + c2, c2, (2, _heads(c2)), device, dtype),
            _block(2 * c2, c2, (2, _heads(c2)), device, dtype),
            _block(c2 + c1, c2, (2, _heads(c2)), device, dtype, tail=up(c2)),
            _block(c2 + c1, c1, None, device, dtype),
            _block(2 * c1, c1, None, device, dtype),
            _block(2 * c1, c1, None, device, dtype),
        )


class MiddleBlock(fl.Chain):
    def __init__(self, base_channels: int = 320, device: Any = None, dtype: Any = None) -> None:
        c4 = 4 * base_channels
        super().__init__(
            ResidualBlock(in_channels=c4, out_channels=c4, device=device, dtype=dtype),
            SDXLCrossAttention(
                channels=c4, num_attention_layers=10, num_attention_heads=_heads(c4), device=device, dtype=dtype
            ),
            ResidualBlock(in_channels=c4, out_channels=c4, device=device, dtype=dtype),
        )


class OutputBlock(fl.Chain):
    def __init__(self, base_channels: int = 320, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.GroupNorm(channels=base_channels, num_groups=32, device=device, dtype=dtype),
            fl.SiLU(),
            fl.Conv2d(
                in_channels=base_channels, out_channels=4, kernel_size=3, stride=1, padding=1, device=device, dtype=dtype
            ),
        )


class SDXLUNet(fl.Chain):
    """SDXL U-Net over NCHW latents.

    `base_channels` (default 320, the real model) scales every stage width
    (c/2c/4c) while keeping the full topology: 10 skip residuals, the
    micro-conditioning, the 2048-dim text context, heads = channels/64."""

    def __init__(self, in_channels: int, base_channels: int = 320, device: Any = None, dtype: Any = None) -> None:
        self.in_channels = in_channels
        self.base_channels = base_channels
        super().__init__(
            TimestepEncoder(base_channels=base_channels, device=device, dtype=dtype),
            DownBlocks(in_channels=in_channels, base_channels=base_channels, device=device, dtype=dtype),
            MiddleBlock(base_channels=base_channels, device=device, dtype=dtype),
            fl.Residual(fl.UseContext(context="unet", key="residuals").compose(lambda x: x[-1])),
            UpBlocks(base_channels=base_channels, device=device, dtype=dtype),
            OutputBlock(base_channels=base_channels, device=device, dtype=dtype),
        )
        for residual_block in self.layers(ResidualBlock):
            chain = residual_block.layer("Chain", fl.Chain)
            RangeAdapter2d(
                target=chain.layer("Conv2d_1", fl.Conv2d),
                channels=residual_block.out_channels,
                embedding_dim=4 * base_channels,
                context_key="timestep_embedding",
                device=device,
                dtype=dtype,
            ).inject(chain)
        for n, block in enumerate(cast(list[fl.Chain], self.DownBlocks)):
            block.append(module=ResidualAccumulator(n=n))
        for n, block in enumerate(cast(list[fl.Chain], self.UpBlocks)):
            block.insert(index=0, module=ResidualConcatenator(n=-n - 2))

    def init_context(self) -> Contexts:
        return {
            "unet": {"residuals": [0.0] * 10},
            "diffusion": {"timestep": None, "time_ids": None, "pooled_text_embedding": None},
            "range_adapter": {"timestep_embedding": None},
            "sampling": {"shapes": []},
        }

    def set_clip_text_embedding(self, clip_text_embedding: torch.Tensor) -> None:
        self.set_context(context="cross_attention_block", value={"clip_text_embedding": clip_text_embedding})

    def set_timestep(self, timestep: torch.Tensor) -> None:
        self.set_context(context="diffusion", value={"timestep": timestep})

    def set_time_ids(self, time_ids: torch.Tensor) -> None:
        self.set_context(context="diffusion", value={"time_ids": time_ids})

    def set_pooled_text_embedding(self, pooled_text_embedding: torch.Tensor) -> None:
        self.set_context(context="diffusion", value={"pooled_text_embedding": pooled_text_embedding})
