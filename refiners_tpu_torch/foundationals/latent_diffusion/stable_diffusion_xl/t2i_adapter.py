"""SDXL's T2I-Adapter; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/t2i_adapter.py``."""

from __future__ import annotations

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import MiddleBlock, SDXLUNet
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL, T2IAdapter, T2IFeatures
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualAccumulator


class SDXLT2IAdapter(T2IAdapter[SDXLUNet]):
    """Adds 3 feature maps to the outputs of down blocks 3, 5 and 8, before
    each stores its skip residual, and the 4th to the middle block's output.
    The default condition encoder is built on the UNet's device and dtype."""

    def __init__(
        self,
        target: SDXLUNet,
        name: str,
        condition_encoder: ConditionEncoderXL | None = None,
        scale: float = 1.0,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        self.residual_indices = (3, 5, 8)
        self._features = [T2IFeatures(name=name, index=i, scale=scale) for i in range(4)]
        super().__init__(
            target=target,
            name=name,
            condition_encoder=condition_encoder or ConditionEncoderXL(device=target.device, dtype=target.dtype),
            weights=weights,
        )

    def inject(self: "SDXLT2IAdapter", parent: fl.Chain | None = None) -> "SDXLT2IAdapter":
        def sanity_check_t2i(block: fl.Chain) -> None:
            for t2i_layer in block.layers(layer_type=T2IFeatures):
                assert t2i_layer.name != self.name, f"T2I-Adapter named {self.name} is already injected"

        # the last feature map goes to the middle block, below
        for n, feat in zip(self.residual_indices, self._features, strict=False):
            block = self.target.layer(("DownBlocks", n), fl.Chain)
            sanity_check_t2i(block)
            block.insert_before_type(ResidualAccumulator, feat)

        mid_block = self.target.layer("MiddleBlock", MiddleBlock)
        sanity_check_t2i(mid_block)
        mid_block.append(self._features[-1])
        return super().inject(parent)

    def eject(self: "SDXLT2IAdapter") -> None:
        for n, feat in zip(self.residual_indices, self._features, strict=False):
            self.target.layer(("DownBlocks", n), fl.Chain).remove(feat)
        self.target.layer("MiddleBlock", MiddleBlock).remove(self._features[-1])
        super().eject()
