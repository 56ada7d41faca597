"""Stable Diffusion 1.5 U-Net (arXiv:2112.10752); counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/unet.py``.

Same block topology and tree paths (so ``state_dict()`` keys match the JAX
package's), NCHW feature maps: 13 skip residuals via the "unet" context,
timestep conditioning injected on every ResidualBlock's first conv, 768-dim
text cross-attention with 8 heads everywhere. At 512² (64×64 latents) the
self-attention sites run at seq 4096 with d = 40 (5 sites) and seq 1024 with
d = 80 (5 sites); those take the flash kernels on the card in bf16.
"""

from __future__ import annotations

from typing import Any, Iterable, cast

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock2d
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeAdapter2d, RangeEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.unet import (
    ResidualAccumulator,
    ResidualBlock,
    ResidualConcatenator,
)


class TimestepEncoder(fl.Passthrough):
    """diffusion/timestep context → RangeEncoder → range_adapter context."""

    def __init__(
        self,
        context_key: str = "timestep_embedding",
        device: Any = None,
        dtype: Any = None,
        base_channels: int = 320,
    ) -> None:
        super().__init__(
            fl.UseContext("diffusion", "timestep"),
            RangeEncoder(base_channels, base_channels * 4, device=device, dtype=dtype),
            fl.SetContext("range_adapter", context_key),
        )


class CLIPLCrossAttention(CrossAttentionBlock2d):
    """768-dim text context, 8 heads."""

    def __init__(self, channels: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            channels=channels,
            context_embedding_dim=768,
            context_key="clip_text_embedding",
            num_attention_heads=8,
            use_bias=False,
            device=device,
            dtype=dtype,
        )


def _res(in_ch: int, out_ch: int, attn: bool, device: Any, dtype: Any, extra: fl.Module | None = None) -> fl.Chain:
    layers: list[fl.Module] = [ResidualBlock(in_channels=in_ch, out_channels=out_ch, device=device, dtype=dtype)]
    if attn:
        layers.append(CLIPLCrossAttention(channels=out_ch, device=device, dtype=dtype))
    if extra is not None:
        layers.append(extra)
    return fl.Chain(*layers)


class DownBlocks(fl.Chain):
    """Conv-in + 3 stages of (res+attn ×2, downsample) + 2 plain res."""

    def __init__(self, in_channels: int, device: Any = None, dtype: Any = None, base_channels: int = 320) -> None:
        self.in_channels = in_channels
        c1, c2, c4 = base_channels, base_channels * 2, base_channels * 4
        blocks: list[fl.Module] = [
            fl.Chain(
                fl.Conv2d(in_channels=in_channels, out_channels=c1, kernel_size=3, padding=1, device=device, dtype=dtype)
            )
        ]
        for cin, cout in [(c1, c1), (c1, c2), (c2, c4)]:
            blocks.append(_res(cin, cout, True, device, dtype))
            blocks.append(_res(cout, cout, True, device, dtype))
            blocks.append(
                fl.Chain(fl.Downsample(channels=cout, scale_factor=2, padding=1, device=device, dtype=dtype))
            )
        blocks.append(_res(c4, c4, False, device, dtype))
        blocks.append(_res(c4, c4, False, device, dtype))
        super().__init__(*blocks)


class UpBlocks(fl.Chain):
    """Mirror of DownBlocks with skip-concat channel widths."""

    def __init__(self, device: Any = None, dtype: Any = None, base_channels: int = 320) -> None:
        c = base_channels
        # (in_channels, out_channels, has_attention, upsample_channels|None)
        spec: list[tuple[int, int, bool, int | None]] = [
            (c * 8, c * 4, False, None),
            (c * 8, c * 4, False, None),
            (c * 8, c * 4, False, c * 4),
            (c * 8, c * 4, True, None),
            (c * 8, c * 4, True, None),
            (c * 6, c * 4, True, c * 4),
            (c * 6, c * 2, True, None),
            (c * 4, c * 2, True, None),
            (c * 3, c * 2, True, c * 2),
            (c * 3, c * 1, True, None),
            (c * 2, c * 1, True, None),
            (c * 2, c * 1, True, None),
        ]
        super().__init__(
            *(
                _res(
                    cin,
                    cout,
                    attn,
                    device,
                    dtype,
                    extra=fl.Upsample(channels=up, device=device, dtype=dtype) if up else None,
                )
                for cin, cout, attn, up in spec
            )
        )


class MiddleBlock(fl.Chain):
    def __init__(self, device: Any = None, dtype: Any = None, base_channels: int = 320) -> None:
        c4 = base_channels * 4
        super().__init__(
            ResidualBlock(in_channels=c4, out_channels=c4, device=device, dtype=dtype),
            CLIPLCrossAttention(channels=c4, device=device, dtype=dtype),
            ResidualBlock(in_channels=c4, out_channels=c4, device=device, dtype=dtype),
        )


class SD1UNet(fl.Chain):
    """SD1.5 U-Net over NCHW latents; `in_channels` is 4 (txt2img) or 9
    (inpainting).

    `base_channels` (default 320, the real model) scales every width while
    keeping the exact block topology and tree paths.
    """

    def __init__(self, in_channels: int, device: Any = None, dtype: Any = None, base_channels: int = 320) -> None:
        self.in_channels = in_channels
        self.base_channels = base_channels
        c1 = base_channels
        super().__init__(
            TimestepEncoder(device=device, dtype=dtype, base_channels=base_channels),
            DownBlocks(in_channels=in_channels, device=device, dtype=dtype, base_channels=base_channels),
            fl.Sum(
                fl.UseContext(context="unet", key="residuals").compose(lambda x: x[-1]),
                MiddleBlock(device=device, dtype=dtype, base_channels=base_channels),
            ),
            UpBlocks(device=device, dtype=dtype, base_channels=base_channels),
            fl.Chain(
                fl.GroupNorm(channels=c1, num_groups=32, device=device, dtype=dtype),
                fl.SiLU(),
                fl.Conv2d(in_channels=c1, out_channels=4, kernel_size=3, stride=1, padding=1, device=device, dtype=dtype),
            ),
        )
        for residual_block in self.layers(ResidualBlock):
            chain = residual_block.layer("Chain", fl.Chain)
            RangeAdapter2d(
                target=chain.layer("Conv2d_1", fl.Conv2d),
                channels=residual_block.out_channels,
                embedding_dim=base_channels * 4,
                context_key="timestep_embedding",
                device=device,
                dtype=dtype,
            ).inject(chain)
        for n, block in enumerate(cast(Iterable[fl.Chain], self.DownBlocks)):
            block.append(ResidualAccumulator(n))
        for n, block in enumerate(cast(Iterable[fl.Chain], self.UpBlocks)):
            block.insert(0, ResidualConcatenator(-n - 2))

    def init_context(self) -> Contexts:
        return {
            "unet": {"residuals": [0.0] * 13},
            "diffusion": {"timestep": None},
            "range_adapter": {"timestep_embedding": None},
            "sampling": {"shapes": []},
        }

    def set_clip_text_embedding(self, clip_text_embedding: torch.Tensor) -> None:
        self.set_context("cross_attention_block", {"clip_text_embedding": clip_text_embedding})

    def set_timestep(self, timestep: torch.Tensor) -> None:
        self.set_context("diffusion", {"timestep": timestep})
