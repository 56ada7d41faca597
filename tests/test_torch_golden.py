"""The port against the committed golden images (`tests/e2e/golden/`).

The JAX package's golden tests (`tests/e2e/test_golden.py`) build their
models from a seed (`tests/e2e/golden_cfg.py`), run fixed prompts and noise
and hold the image to a committed PNG. Here the same JAX models are built,
their weights bridged into the port on the CPU, and the same prompts, noise
and steps run through the port, in the JAX tests' envelope: PSNR ≥ 35,
SSIM ≥ 0.98, DINOv2 cosine ≥ 0.99.
"""

from __future__ import annotations

import gc
from typing import Any

import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DPMSolver,
    SD1Autoencoder,
    SD1UNet,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_1,
    StableDiffusion_XL,
)
from tests.e2e.golden_cfg import GOLDEN_DIR, build_sd15_full, build_sd15_reduced, build_sdxl_full, to_pil
from tests.utils import ensure_similar_images

PROMPT, NEGATIVE = "a cute cat, best quality", "low quality, blurry"  # golden_cfg.run_sd15_*


def _bridge(port: Any, jax_model: Any) -> Any:
    """Load the JAX model's UNet, VAE and text encoder into the port's (strict), then drop the JAX model."""
    for name in ("unet", "lda", "clip_text_encoder"):
        state = getattr(jax_model, name).state_dict()
        load_jax_state_dict(getattr(port, name), {k: np.asarray(v) for k, v in state.items()})
    return port


def _check(name: str, image: torch.Tensor) -> None:
    golden = Image.open(GOLDEN_DIR / f"{name}.png")
    ensure_similar_images(to_pil(nchw_to_nhwc(image.numpy())), golden, min_psnr=35, min_ssim=0.98, min_dino_cosine=0.99)


def _sd15(sd: StableDiffusion_1, latent: int, scale_input: bool) -> torch.Tensor:
    """`golden_cfg.run_sd15_reduced` / `run_sd15_full` through the port."""
    noise = torch.tensor(nhwc_to_nchw(np.random.RandomState(0).randn(1, latent, latent, 4).astype(np.float32)))
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(PROMPT, negative_text=NEGATIVE)
        x = sd.solver.scale_model_input(noise, step=-1) if scale_input else noise
        return sd.lda.decode(sd.diffuse(x, clip_text_embedding=emb, condition_scale=7.5))


def test_sd15_reduced_10step_golden() -> None:
    """`build_sd15_reduced`: SD1UNet(base_channels=32), a 2-layer CLIP-L, the
    full VAE, 10 DDIM steps at 128²."""
    port = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DDIM(num_inference_steps=10),
        device="cpu",
    )
    _bridge(port, build_sd15_reduced())
    _check("sd15_reduced_10step_128", _sd15(port, latent=16, scale_input=True))


@pytest.mark.slow
def test_sd15_full_30step_golden() -> None:
    """`build_sd15_full`: full-width SD1.5, 30 DPM++ steps at 256²."""
    port = _bridge(StableDiffusion_1(solver=DPMSolver(num_inference_steps=30), device="cpu"), build_sd15_full())
    gc.collect()
    _check("sd15_full_30step_256", _sd15(port, latent=32, scale_input=False))


@pytest.mark.slow
def test_sdxl_full_30step_golden() -> None:
    """`build_sdxl_full`: full-width SDXL, the text encoder stubbed (the
    embeddings given), 30 DDIM steps at 256²; `golden_cfg.run_sdxl_full`."""
    port = StableDiffusion_XL(
        unet=SDXLUNet(in_channels=4),
        lda=SDXLAutoencoder(),
        clip_text_encoder=fl.Chain(fl.Identity()),
        solver=DDIM(num_inference_steps=30),
        device="cpu",
    )
    _bridge(port, build_sdxl_full())
    gc.collect()
    rs = np.random.RandomState(74)
    emb = torch.tensor(rs.randn(2, 77, 2048).astype(np.float32))
    pooled = torch.tensor(rs.randn(2, 1280).astype(np.float32))
    noise = torch.tensor(nhwc_to_nchw(rs.randn(1, 32, 32, 4).astype(np.float32)))
    with torch.inference_mode():
        z = port.diffuse(
            noise, clip_text_embedding=emb, pooled_text_embedding=pooled, time_ids=port.default_time_ids,
            condition_scale=5.0,
        )  # fmt: skip
        image = port.lda.decode(z)
    _check("sdxl_full_30step_256", image)
