"""T2I-Adapter (arXiv:2302.08453): a condition feature pyramid added to the
UNet's skips; counterpart of
``refiners_tpu/foundationals/latent_diffusion/t2i_adapter.py``.

NCHW. The encoder's first layer is a PixelUnshuffle, whose channel order
(c·r² + dy·r + dx) is torch's, so checkpoints load as they are.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Generic, TypeVar

import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts

if TYPE_CHECKING:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

T = TypeVar("T", bound="SD1UNet | SDXLUNet")
TT2IAdapter = TypeVar("TT2IAdapter", bound="T2IAdapter[Any]")


class Downsample2d(fl.Module):
    """Average pooling by `scale_factor` over NCHW."""

    def __init__(self, scale_factor: int) -> None:
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.scale_factor)


class ResidualBlock(fl.Residual):
    def __init__(self, channels: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.Conv2d(in_channels=channels, out_channels=channels, kernel_size=3, padding=1, device=device, dtype=dtype),
            fl.ReLU(),
            fl.Conv2d(in_channels=channels, out_channels=channels, kernel_size=1, device=device, dtype=dtype),
        )


class ResidualBlocks(fl.Chain):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_residual_blocks: int = 2,
        downsample: bool = False,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        preproc = Downsample2d(scale_factor=2) if downsample else fl.Identity()
        shortcut = (
            fl.Conv2d(in_channels=in_channels, out_channels=out_channels, kernel_size=1, device=device, dtype=dtype)
            if in_channels != out_channels
            else fl.Identity()
        )
        super().__init__(
            preproc,
            shortcut,
            fl.Chain(ResidualBlock(channels=out_channels, device=device, dtype=dtype) for _ in range(num_residual_blocks)),
        )


class StatefulResidualBlocks(fl.Chain):
    """ResidualBlocks that also push their output onto the "t2iadapter"/"features" list."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_residual_blocks: int = 2,
        downsample: bool = False,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            ResidualBlocks(
                in_channels=in_channels,
                out_channels=out_channels,
                num_residual_blocks=num_residual_blocks,
                downsample=downsample,
                device=device,
                dtype=dtype,
            ),
            fl.SetContext(context="t2iadapter", key="features", callback=self.push),
        )

    def push(self, features: list[torch.Tensor], x: torch.Tensor) -> None:
        features.append(x)


class ConditionEncoder(fl.Chain):
    """(B, 3, H, W) condition image → 4 feature maps at H/8 ... H/64."""

    def __init__(
        self,
        in_channels: int = 3,
        channels: tuple[int, int, int, int] = (320, 640, 1280, 1280),
        num_residual_blocks: int = 2,
        downscale_factor: int = 8,
        scale: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.scale = scale
        super().__init__(
            fl.PixelUnshuffle(downscale_factor=downscale_factor),
            fl.Conv2d(
                in_channels=in_channels * downscale_factor**2,
                out_channels=channels[0],
                kernel_size=3,
                padding=1,
                device=device,
                dtype=dtype,
            ),
            StatefulResidualBlocks(channels[0], channels[0], num_residual_blocks, device=device, dtype=dtype),
            *(
                StatefulResidualBlocks(
                    channels[i - 1], channels[i], num_residual_blocks, downsample=True, device=device, dtype=dtype
                )
                for i in range(1, len(channels))
            ),
            fl.UseContext(context="t2iadapter", key="features"),
        )

    def init_context(self) -> Contexts:
        return {"t2iadapter": {"features": []}}


class ConditionEncoderXL(ConditionEncoder, fl.Chain):
    """SDXL's: a downscale of 16 and a single downsampling block mid-pyramid."""

    def __init__(
        self,
        in_channels: int = 3,
        channels: tuple[int, int, int, int] = (320, 640, 1280, 1280),
        num_residual_blocks: int = 2,
        downscale_factor: int = 16,
        scale: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.scale = scale
        fl.Chain.__init__(
            self,
            fl.PixelUnshuffle(downscale_factor=downscale_factor),
            fl.Conv2d(
                in_channels=in_channels * downscale_factor**2,
                out_channels=channels[0],
                kernel_size=3,
                padding=1,
                device=device,
                dtype=dtype,
            ),
            StatefulResidualBlocks(channels[0], channels[0], num_residual_blocks, device=device, dtype=dtype),
            StatefulResidualBlocks(channels[0], channels[1], num_residual_blocks, device=device, dtype=dtype),
            StatefulResidualBlocks(
                channels[1], channels[2], num_residual_blocks, downsample=True, device=device, dtype=dtype
            ),
            StatefulResidualBlocks(channels[2], channels[3], num_residual_blocks, device=device, dtype=dtype),
            fl.UseContext(context="t2iadapter", key="features"),
        )


class T2IFeatures(fl.Residual):
    """Add condition feature map #index, scaled, to the passing activation."""

    def __init__(self, name: str, index: int, scale: float = 1.0) -> None:
        self.name = name
        self.index = index
        self.scale = scale
        super().__init__(
            fl.UseContext(context="t2iadapter", key=f"condition_features_{self.name}").compose(
                func=lambda features: self.scale * features[self.index]
            )
        )


class T2IAdapter(Generic[T], fl.Chain, Adapter[T]):
    """Adds the features of a named condition encoder to the UNet's skips;
    the encoder is not a module of the UNet, and runs once per condition
    (`compute_condition_features`), not once per step."""

    _condition_encoder: list[ConditionEncoder]
    _features: list[T2IFeatures] = []

    def __init__(
        self,
        target: T,
        name: str,
        condition_encoder: ConditionEncoder,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        self.name = name
        if weights is not None:
            condition_encoder.load_state_dict(weights)
        # a list keeps torch from registering the encoder in the adapter
        self._condition_encoder = [condition_encoder]
        with self.setup_adapter(target):
            super().__init__(target)

    @property
    def condition_encoder(self) -> ConditionEncoder:
        return self._condition_encoder[0]

    def compute_condition_features(self, condition: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The features of a (B, 3, H, W) condition image in [0, 1], computed
        on the encoder's device and in its dtype."""
        encoder = self.condition_encoder
        return encoder(condition.to(device=encoder.device, dtype=encoder.dtype))

    def set_condition_features(self, features: tuple[torch.Tensor, ...]) -> None:
        self.set_context("t2iadapter", {f"condition_features_{self.name}": features})

    @property
    def scale(self) -> float:
        return self._features[0].scale

    @scale.setter
    def scale(self, value: float) -> None:
        for f in self._features:
            f.scale = value

    def init_context(self) -> Contexts:
        return {"t2iadapter": {f"condition_features_{self.name}": None}}

    def structural_copy(self: "TT2IAdapter") -> "TT2IAdapter":
        raise RuntimeError("T2I-Adapter cannot be copied, eject it first.")
