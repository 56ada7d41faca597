"""Shared UNet building blocks; counterpart of
``refiners_tpu/foundationals/latent_diffusion/unet.py``. NCHW: skip
connections concatenate on channel dim 1."""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl


class ResidualBlock(fl.Sum):
    """GN → SiLU → Conv, twice, plus a shortcut."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_groups: int = 32,
        eps: float = 1e-5,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        if in_channels % num_groups != 0 or out_channels % num_groups != 0:
            raise ValueError("Number of input and output channels must be divisible by num_groups.")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_groups = num_groups
        self.eps = eps
        shortcut = (
            fl.Conv2d(in_channels=in_channels, out_channels=out_channels, kernel_size=1, device=device, dtype=dtype)
            if in_channels != out_channels
            else fl.Identity()
        )
        super().__init__(
            fl.Chain(
                fl.GroupNorm(channels=in_channels, num_groups=num_groups, eps=eps, device=device, dtype=dtype),
                fl.SiLU(),
                fl.Conv2d(
                    in_channels=in_channels, out_channels=out_channels, kernel_size=3, padding=1, device=device, dtype=dtype
                ),
                fl.GroupNorm(channels=out_channels, num_groups=num_groups, eps=eps, device=device, dtype=dtype),
                fl.SiLU(),
                fl.Conv2d(
                    in_channels=out_channels, out_channels=out_channels, kernel_size=3, padding=1, device=device, dtype=dtype
                ),
            ),
            shortcut,
        )


class ResidualAccumulator(fl.Passthrough):
    """Write skip #n into the "unet/residuals" context."""

    def __init__(self, n: int) -> None:
        self.n = n
        super().__init__(
            fl.Residual(
                fl.UseContext(context="unet", key="residuals").compose(func=lambda residuals: residuals[self.n])
            ),
            fl.SetContext(context="unet", key="residuals", callback=self.update),
        )

    def update(self, residuals: list[torch.Tensor | float], x: torch.Tensor) -> None:
        residuals[self.n] = x


class ResidualConcatenator(fl.Chain):
    """Concatenate skip #n on the channel dim."""

    def __init__(self, n: int) -> None:
        self.n = n
        super().__init__(
            fl.Concatenate(
                fl.Identity(),
                fl.UseContext(context="unet", key="residuals").compose(lambda residuals: residuals[self.n]),
                dim=1,
            ),
        )
