"""The port's SDXL slice against the JAX package, on the CPU.

A reduced-width SDXL UNet (base_channels=32: the full topology, 32/64/128
channels), the full-width SDXL VAE and a one-layer text encoder (unused:
the embeddings are given) are built in JAX from a seed and bridged into the
port. Latents, noise and embeddings are numpy arrays handed to both.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refiners_tpu.foundationals.clip.text_encoder import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import DoubleTextEncoder as JaxDoubleTextEncoder
from refiners_tpu.foundationals.latent_diffusion import SDXLAutoencoder as JaxSDXLAutoencoder
from refiners_tpu.foundationals.latent_diffusion import SDXLUNet as JaxSDXLUNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_XL as JaxStableDiffusion_XL
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DoubleTextEncoder,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_XL,
)

# float32 on both sides. One module: only the summation order differs.
MODULE_TOL = 1e-5
# The chained slice (3 UNet steps, then the VAE): deep UNets amplify float
# noise at every cross-attention block (.claude/skills/verify/SKILL.md).
SLICE_TOL = 1e-4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _text_encoder(encoder: Any, tokenizer: Any, double: Any) -> Any:
    small = dict(num_layers=1, vocabulary_size=1000, feedforward_dim=64)
    text_l = encoder(embedding_dim=768, num_attention_heads=12, use_quick_gelu=True, **small)
    text_g = encoder(embedding_dim=1280, num_attention_heads=20, tokenizer=tokenizer(pad_token_id=0), **small)
    return double(text_encoder_l=text_l, text_encoder_g=text_g)


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_XL]:
    jax_sd = JaxStableDiffusion_XL(
        unet=JaxSDXLUNet(in_channels=4, base_channels=32),
        lda=JaxSDXLAutoencoder(),
        clip_text_encoder=_text_encoder(JaxCLIPTextEncoder, JaxCLIPTokenizer, JaxDoubleTextEncoder),
        solver=JaxDDIM(num_inference_steps=STEPS),
    )
    port_sd = StableDiffusion_XL(
        unet=SDXLUNet(in_channels=4, base_channels=32),
        lda=SDXLAutoencoder(),
        clip_text_encoder=_text_encoder(CLIPTextEncoder, CLIPTokenizer, DoubleTextEncoder),
        solver=DDIM(num_inference_steps=STEPS),
        device="cpu",
    )
    for name in ("unet", "lda", "clip_text_encoder"):
        state = getattr(jax_sd, name).state_dict()
        load_jax_state_dict(getattr(port_sd, name), {k: np.asarray(v) for k, v in state.items()})
    return jax_sd, port_sd


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(0)
    return {
        "x": rs.randn(1, 16, 16, 4).astype(np.float32),  # NHWC, as the JAX package takes it
        "clip_text_embedding": rs.randn(2, 77, 2048).astype(np.float32),
        "pooled_text_embedding": rs.randn(2, 1280).astype(np.float32),
        "time_ids": np.array([[1024, 1024, 0, 0, 1024, 1024]] * 2, dtype=np.float32),
    }


def _port_kwargs(inputs: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(v) for k, v in inputs.items() if k != "x"}


def _jax_kwargs(inputs: dict[str, np.ndarray]) -> dict[str, jax.Array]:
    return {k: jnp.asarray(v) for k, v in inputs.items() if k != "x"}


@pytest.fixture(scope="module")
def jax_step(models: tuple[Any, StableDiffusion_XL]) -> Any:
    """The JAX model's denoising step, compiled once with a traced step index
    (its solver is branch-free in the step) and reused by every test."""
    return jax.jit(lambda sd, x, step, kwargs: sd(x, step, condition_scale=5.0, **kwargs))


def test_unet_cfg_step_matches_jax(
    models: tuple[Any, StableDiffusion_XL], inputs: dict[str, np.ndarray], jax_step: Any
) -> None:
    """One denoising step: CFG batch 2 through the UNet, guidance, DDIM update."""
    jax_sd, port_sd = models
    want = jax_step(jax_sd, jnp.asarray(inputs["x"]), 0, _jax_kwargs(inputs))
    with torch.inference_mode():
        got = port_sd(torch.tensor(nhwc_to_nchw(inputs["x"])), 0, condition_scale=5.0, **_port_kwargs(inputs))
    assert got.shape == (1, 4, 16, 16)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= MODULE_TOL


def test_ddim_tables_and_steps_match_jax() -> None:
    jax_solver, port_solver = JaxDDIM(num_inference_steps=30), DDIM(num_inference_steps=30)
    for name in ("timesteps", "cumulative_scale_factors", "noise_std", "signal_to_noise_ratios"):
        np.testing.assert_array_equal(getattr(port_solver, name).numpy(), np.asarray(getattr(jax_solver, name)))
    assert port_solver.timesteps.dtype == torch.int32
    rs = np.random.RandomState(1)
    x, noise = rs.randn(1, 4, 8, 8).astype(np.float32), rs.randn(1, 4, 8, 8).astype(np.float32)
    for step in (0, 14, 29):  # first, middle, last (no noise term)
        want = np.asarray(jax_solver(jnp.asarray(x), jnp.asarray(noise), step))
        got = port_solver(torch.tensor(x), torch.tensor(noise), step).numpy()
        assert _rel(got, want) <= 1e-6  # elementwise float32 arithmetic, same formula


def test_vae_decode_matches_jax(models: tuple[Any, StableDiffusion_XL]) -> None:
    """The full-width SDXL VAE decoder at 8×8 latents (a 64×64 image)."""
    jax_sd, port_sd = models
    z = np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32)
    want = np.asarray(jax.jit(lambda lda, z: lda.decode(z))(jax_sd.lda, jnp.asarray(z)))
    with torch.inference_mode():
        got = port_sd.lda.decode(torch.tensor(nhwc_to_nchw(z)))
    assert got.shape == (1, 3, 64, 64)
    assert _rel(nchw_to_nhwc(got.numpy()), want) <= MODULE_TOL


def test_slice_diffuse_and_decode_match_jax(
    models: tuple[Any, StableDiffusion_XL], inputs: dict[str, np.ndarray], jax_step: Any
) -> None:
    """The whole slice: 3 DDIM steps with CFG 5.0, then the VAE decode. The
    JAX reference runs its steps one by one (what its `diffuse` scans)."""
    jax_sd, port_sd = models
    x = jnp.asarray(inputs["x"])
    for step in range(STEPS):
        x = jax_step(jax_sd, x, step, _jax_kwargs(inputs))
    want = np.asarray(jax.jit(lambda lda, z: lda.decode(z))(jax_sd.lda, x))
    with torch.inference_mode():
        latents = port_sd.diffuse(torch.tensor(nhwc_to_nchw(inputs["x"])), condition_scale=5.0, **_port_kwargs(inputs))
        got = port_sd.lda.decode(latents)
    assert got.shape == (1, 3, 128, 128)
    assert np.isfinite(got.numpy()).all()
    assert _rel(nchw_to_nhwc(got.numpy()), want) <= SLICE_TOL
