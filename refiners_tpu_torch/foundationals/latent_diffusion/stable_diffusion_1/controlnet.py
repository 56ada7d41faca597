"""SD1.5 ControlNet (arXiv:2302.05543); counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_1/controlnet.py``.

A copy of the UNet's down and middle blocks, always at full width, runs
before the UNet in the same call. Its condition encoder adds the condition
image's features after the first convolution, and a 1×1 convolution after
each of its 13 blocks adds the block's output, scaled, to the UNet's skip
residual of the same index in the "unet"/"residuals" context. Latents are
NCHW, so the inpainting slice keeps the first 4 channels of dim 1. At 512²
its self-attention runs at seq 4096 (d = 40) and seq 1024 (d = 80), two
sites each: 4 more K1 launches per UNet call on the card in bf16.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.layers import Chain, Conv2d, Lambda, Passthrough, Residual, SiLU, Slicing, UseContext
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeAdapter2d
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import (
    DownBlocks,
    MiddleBlock,
    ResidualBlock,
    SD1UNet,
    TimestepEncoder,
)


class ConditionEncoder(Chain):
    """(B, 3, H, W) condition image → (B, 320, H/8, W/8) features."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        self.out_channels = (16, 32, 96, 256)
        super().__init__(
            Chain(
                Conv2d(in_channels=3, out_channels=self.out_channels[0], kernel_size=3, stride=1, padding=1,
                       device=device, dtype=dtype),  # fmt: skip
                SiLU(),
            ),
            *(
                Chain(
                    Conv2d(
                        in_channels=self.out_channels[i],
                        out_channels=self.out_channels[i],
                        kernel_size=3,
                        padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    SiLU(),
                    Conv2d(
                        in_channels=self.out_channels[i],
                        out_channels=self.out_channels[i + 1],
                        kernel_size=3,
                        stride=2,
                        padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    SiLU(),
                )
                for i in range(len(self.out_channels) - 1)
            ),
            Conv2d(in_channels=self.out_channels[-1], out_channels=320, kernel_size=3, padding=1, device=device,
                   dtype=dtype),  # fmt: skip
        )


class Controlnet(Passthrough):
    """Half a UNet that adds its scaled block outputs to the UNet's skip residuals."""

    scale_decays: list[float]

    def __init__(
        self,
        name: str,
        scale: float = 1.0,
        scale_decay: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.name = name
        self.scale = scale
        self._scale_decay = scale_decay
        self.compute_scale_decays()
        super().__init__(
            TimestepEncoder(context_key=f"timestep_embedding_{name}", device=device, dtype=dtype),
            Slicing(dim=1, end=4),  # an inpainting UNet's latents: the first 4 channels
            DownBlocks(in_channels=4, device=device, dtype=dtype),
            MiddleBlock(device=device, dtype=dtype),
        )

        self.layer(("DownBlocks", 0), Chain).append(
            Residual(
                UseContext("controlnet", f"condition_{name}"),
                ConditionEncoder(device=device, dtype=dtype),
            ),
        )
        for residual_block in self.layers(ResidualBlock):
            chain = residual_block.layer("Chain", Chain)
            RangeAdapter2d(
                target=chain.layer("Conv2d_1", Conv2d),
                channels=residual_block.out_channels,
                embedding_dim=1280,
                context_key=f"timestep_embedding_{name}",
                device=device,
                dtype=dtype,
            ).inject(chain)
        for n, block in enumerate(self.layer("DownBlocks", DownBlocks)):
            assert isinstance(block, Chain)
            out_channels = block[0].out_channels
            block.append(
                Passthrough(
                    Conv2d(in_channels=out_channels, out_channels=out_channels, kernel_size=1, device=device,
                           dtype=dtype),  # fmt: skip
                    Lambda(self._store_nth_residual(n)),
                )
            )
        self.layer("MiddleBlock", MiddleBlock).append(
            Passthrough(
                Conv2d(in_channels=1280, out_channels=1280, kernel_size=1, device=device, dtype=dtype),
                Lambda(self._store_nth_residual(12)),
            )
        )

    def _store_nth_residual(self, n: int) -> Callable[[torch.Tensor], torch.Tensor]:
        def _store_residual(x: torch.Tensor) -> torch.Tensor:
            residuals = self.use_context("unet")["residuals"]
            residuals[n] = residuals[n] + x * self.scale * self.scale_decays[n]
            return x

        return _store_residual

    @property
    def scale_decay(self) -> float:
        return self._scale_decay

    @scale_decay.setter
    def scale_decay(self, value: float) -> None:
        self._scale_decay = value
        self.compute_scale_decays()

    def compute_scale_decays(self) -> None:
        # 0.825 is sd-webui-controlnet's "prompt is more important" mode
        self.scale_decays = [self.scale_decay ** float(12 - i) for i in range(13)]


class SD1ControlnetAdapter(Chain, Adapter[SD1UNet]):
    """Puts a named `Controlnet` first in the UNet on `inject()`; several,
    each with its own name, stack. Built on the UNet's device and dtype;
    `weights` is a state dict of the `Controlnet` in the port's layout."""

    def __init__(
        self,
        target: SD1UNet,
        name: str,
        scale: float = 1.0,
        scale_decay: float = 1.0,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        self.name = name
        controlnet = Controlnet(
            name=name, scale=scale, scale_decay=scale_decay, device=target.device, dtype=target.dtype
        )
        if weights is not None:
            controlnet.load_state_dict(weights)
        # a list keeps torch from registering the Controlnet here: `inject` puts it in the UNet
        self._controlnet: list[Controlnet] = [controlnet]
        with self.setup_adapter(target):
            super().__init__(target)

    def inject(self: "SD1ControlnetAdapter", parent: Chain | None = None) -> "SD1ControlnetAdapter":
        controlnet = self._controlnet[0]
        target_controlnets = [x for x in self.target if isinstance(x, Controlnet)]
        assert controlnet not in target_controlnets, f"{controlnet} is already injected"
        for cn in target_controlnets:
            assert cn.name != self.name, f"Controlnet named {self.name} is already injected"
        self.target.insert(0, controlnet)
        return super().inject(parent)

    def eject(self) -> None:
        self.target.remove(self._controlnet[0])
        super().eject()

    @property
    def controlnet(self) -> Controlnet:
        return self._controlnet[0]

    def init_context(self) -> Contexts:
        return {"controlnet": {f"condition_{self.name}": None}}

    @property
    def scale(self) -> float:
        return self.controlnet.scale

    @scale.setter
    def scale(self, value: float) -> None:
        self.controlnet.scale = value

    @property
    def scale_decay(self) -> float:
        return self.controlnet.scale_decay

    @scale_decay.setter
    def scale_decay(self, value: float) -> None:
        self.controlnet.scale_decay = value

    def set_controlnet_condition(self, condition: torch.Tensor) -> None:
        """The (B, 3, H, W) condition image in [0, 1], for the latents of
        (·, 4, H/8, W/8); batch 1 serves the whole CFG batch. It is cast to
        the Controlnet's device and dtype, so that a float32 image does not
        turn a bf16 UNet's residuals to float32."""
        condition = condition.to(device=self.controlnet.device, dtype=self.controlnet.dtype)
        self.set_context("controlnet", {f"condition_{self.name}": condition})

    def structural_copy(self: "SD1ControlnetAdapter") -> "SD1ControlnetAdapter":
        raise RuntimeError("Controlnet cannot be copied, eject it first.")
