"""SDXL's LCM adapter: a condition-scale embedding for LCM-distilled UNets;
counterpart of ``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/lcm.py``."""

from __future__ import annotations

import math
from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet


def compute_sinusoidal_embedding(x: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """(B,) → (B, embedding_dim) float32 embedding [sin | cos], the exponent
    divided by half_dim - 1: LCM's convention, unlike the RangeEncoder's
    [cos | sin] divided by half_dim."""
    half_dim = embedding_dim // 2
    exponent = -math.log(10000) * torch.arange(half_dim, dtype=torch.float32, device=x.device) / (half_dim - 1)
    embedding = x[:, None].float() * torch.exp(exponent)[None]
    out = torch.cat([torch.sin(embedding), torch.cos(embedding)], dim=-1)
    assert out.shape == (x.shape[0], embedding_dim)
    return out


class ConditionScaleBlock(fl.Residual):
    """Adds a projection of the "lcm" condition-scale embedding to the
    timestep's sinusoidal embedding."""

    def __init__(self, in_channels: int, out_channels: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__(
            fl.UseContext("lcm", "condition_scale_embedding"),
            fl.Converter(),
            fl.Linear(in_features=in_channels, out_features=out_channels, bias=False, device=device, dtype=dtype),
        )


class SDXLLcmAdapter(fl.Chain, Adapter[SDXLUNet]):
    """Adapts an SDXLUNet to an LCM-distilled one, for the LCMSolver without
    classifier-free guidance: the guidance scale enters as an embedding. The
    block it adds is built on the UNet's device and in its dtype."""

    def __init__(
        self,
        target: SDXLUNet,
        condition_scale_embedding_dim: int = 256,
        condition_scale: float = 7.5,
    ) -> None:
        assert condition_scale_embedding_dim % 2 == 0
        self.condition_scale_embedding_dim = condition_scale_embedding_dim
        self.condition_scale = condition_scale
        with self.setup_adapter(target):
            super().__init__(target)

    def init_context(self) -> Contexts:
        return {"lcm": {"condition_scale_embedding": self.sinusoidal_embedding}}

    @property
    def sinusoidal_embedding(self) -> torch.Tensor:
        scale = torch.tensor([(self.condition_scale - 1) * 1000], device=self.target.device)
        return compute_sinusoidal_embedding(scale, embedding_dim=self.condition_scale_embedding_dim)

    def set_condition_scale(self, scale: float) -> None:
        self.condition_scale = scale
        self.set_context("lcm", {"condition_scale_embedding": self.sinusoidal_embedding})

    def inject(self: "SDXLLcmAdapter", parent: fl.Chain | None = None) -> "SDXLLcmAdapter":
        ra = self.target.ensure_find(RangeEncoder)
        block = ConditionScaleBlock(
            in_channels=self.condition_scale_embedding_dim,
            out_channels=ra.sinusoidal_embedding_dim,
            device=self.target.device,
            dtype=self.target.dtype,
        )
        ra.insert_before_type(fl.Linear, block)
        return super().inject(parent)

    def eject(self) -> None:
        ra = self.target.ensure_find(RangeEncoder)
        ra.remove(ra.ensure_find(ConditionScaleBlock))
        super().eject()
