"""Where the port's model facades build: on the card unless told otherwise.

`StableDiffusion_XL`, `LatentDiffusionModel`, `SegmentAnything` and
`SegmentAnythingH` take ``device=None`` as the card (``cuda``), never as the
CPU; CPU use passes ``device="cpu"``. Layers stay building blocks: the facade
passes its device down.
"""

from __future__ import annotations

import pytest
import torch

from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, SDXLAutoencoder, SDXLUNet, StableDiffusion_XL
from refiners_tpu_torch.foundationals.segment_anything import (
    MaskDecoder,
    MaskEncoder,
    PointEncoder,
    SAMViT,
    SegmentAnything,
)


def test_default_device_is_the_card() -> None:
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("meta")) == torch.device("meta")


def test_a_given_device_is_kept() -> None:
    sd = StableDiffusion_XL(device="meta")
    assert {p.device.type for p in sd.parameters()} == {"meta"}
    assert sd.solver.timesteps.device.type == "meta"


def test_facades_without_a_device_go_to_the_card() -> None:
    """Parts built on the CPU move to the card; with no card, building raises
    (there is no fallback to the CPU)."""

    def build_sd() -> StableDiffusion_XL:
        return StableDiffusion_XL(unet=SDXLUNet(in_channels=4, base_channels=32), lda=SDXLAutoencoder(),
                                  clip_text_encoder=None, solver=DDIM(num_inference_steps=2))  # fmt: skip

    def build_sam() -> SegmentAnything:
        return SegmentAnything(
            SAMViT(embedding_dim=32, num_layers=2, num_heads=2, global_attention_indices=(1,)),
            PointEncoder(), MaskEncoder(), MaskDecoder(multimask_output=False),
        )  # fmt: skip

    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_sam()
        with pytest.raises((RuntimeError, AssertionError)):
            StableDiffusion_XL(unet=SDXLUNet(in_channels=4, base_channels=32), solver=DDIM(num_inference_steps=2))
        return
    for model in (build_sd(), build_sam()):
        assert {p.device.type for p in model.parameters()} == {"cuda"}
