"""FreeU (arXiv:2309.11497): scaled backbone features and low-pass-scaled
skips in the first up blocks; counterpart of
``refiners_tpu/foundationals/latent_diffusion/freeu.py``.

NCHW: the FFT runs over dims (-2, -1), in float32 (cuFFT has no bf16), and
the backbone scale takes the first half of the channels, dim 1.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Generic, TypeVar

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualConcatenator

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")
TSDFreeUAdapter = TypeVar("TSDFreeUAdapter", bound="SDFreeUAdapter[Any]")


def fourier_filter(x: torch.Tensor, scale: float = 1, threshold: int = 1) -> torch.Tensor:
    """Scale the 2·threshold × 2·threshold lowest frequencies of the spatial
    spectrum of NCHW `x` by `scale`."""
    height, width = x.shape[-2:]
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(-2, -1)), dim=(-2, -1))
    mask = torch.ones((height, width), dtype=torch.float32, device=x.device)
    cr, cc = height // 2, width // 2
    mask[cr - threshold : cr + threshold, cc - threshold : cc + threshold].fill_(scale)  # no host scalar copied up
    x_freq = torch.fft.ifftshift(x_freq * mask, dim=(-2, -1))
    return torch.fft.ifftn(x_freq, dim=(-2, -1)).real.to(x.dtype)


class FreeUBackboneFeatures(fl.Module):
    def __init__(self, backbone_scale: float) -> None:
        super().__init__()
        self.backbone_scale = backbone_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        num_half_channels = x.shape[1] // 2
        return torch.cat([x[:, :num_half_channels] * self.backbone_scale, x[:, num_half_channels:]], dim=1)


class FreeUSkipFeatures(fl.Chain):
    def __init__(self, n: int, skip_scale: float) -> None:
        apply_filter: Callable[[torch.Tensor], torch.Tensor] = lambda x: fourier_filter(x, scale=skip_scale)
        super().__init__(
            fl.UseContext(context="unet", key="residuals").compose(lambda residuals: residuals[n]),
            fl.Lambda(apply_filter),
        )


class FreeUResidualConcatenator(fl.Concatenate):
    def __init__(self, n: int, backbone_scale: float, skip_scale: float) -> None:
        super().__init__(
            FreeUBackboneFeatures(backbone_scale),
            FreeUSkipFeatures(n, skip_scale),
            dim=1,
        )


class SDFreeUAdapter(Generic[T], fl.Chain, Adapter[T]):
    """Replaces the ResidualConcatenator of the first len(backbone_scales)
    up blocks by FreeU's, and puts it back on `eject()`."""

    def __init__(self, target: T, backbone_scales: list[float], skip_scales: list[float]) -> None:
        assert len(backbone_scales) == len(skip_scales)
        assert len(backbone_scales) <= len(target.layer("UpBlocks", fl.Chain))
        self.backbone_scales = backbone_scales
        self.skip_scales = skip_scales
        with self.setup_adapter(target):
            super().__init__(target)

    def inject(self: TSDFreeUAdapter, parent: fl.Chain | None = None) -> TSDFreeUAdapter:
        for n, (backbone_scale, skip_scale) in enumerate(zip(self.backbone_scales, self.skip_scales)):
            block = self.target.layer(("UpBlocks", n), fl.Chain)
            concat = block.ensure_find(ResidualConcatenator)
            block.replace(concat, FreeUResidualConcatenator(-n - 2, backbone_scale, skip_scale))
        return super().inject(parent)

    def eject(self) -> None:
        for n in range(len(self.backbone_scales)):
            block = self.target.layer(("UpBlocks", n), fl.Chain)
            concat = block.ensure_find(FreeUResidualConcatenator)
            block.replace(concat, ResidualConcatenator(-n - 2))
        super().eject()
