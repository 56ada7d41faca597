"""The port's SD1.5 inference slice against the JAX package, on the CPU.

At the JAX tests' reduced size: `SD1UNet(base_channels=32)` (the full
topology, 32/64/128 channels), a 2-layer 768-wide CLIP-L and the full SD1
VAE, built in JAX from a seed and bridged into the port with strict=True.
Latents, noise, images and embeddings are numpy arrays handed to both.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip import CLIPTextEncoderL as JaxCLIPTextEncoderL
from refiners_tpu.foundationals.latent_diffusion import DPMSolver as JaxDPMSolver
from refiners_tpu.foundationals.latent_diffusion import LCMSolver as JaxLCMSolver
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1_Inpainting as JaxInpainting
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DPMSolver,
    LCMSolver,
    SD1Autoencoder,
    SD1UNet,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
)
from refiners_tpu_torch.pipelines import TextToImage

# float32 on both sides. One step: only the summation order differs.
MODULE_TOL = 1e-5
# The chained slice (3 UNet steps, then the VAE): deep UNets amplify float
# noise at every cross-attention block (as in tests/test_torch_sdxl.py).
SLICE_TOL = 1e-4
STEPS = 3
SD1_UNET_PARAMETERS = 859_520_964


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridge(port: torch.nn.Module, jax_module: Any) -> None:
    load_jax_state_dict(port, {k: np.asarray(v) for k, v in jax_module.state_dict().items()}, strict=True)


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_1]:
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_1(
        unet=JaxSD1UNet(in_channels=4, base_channels=32),
        lda=JaxSD1Autoencoder(),
        clip_text_encoder=JaxCLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=JaxDPMSolver(num_inference_steps=STEPS),
    )
    port_sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DPMSolver(num_inference_steps=STEPS),
        device="cpu",
    )
    for name in ("unet", "lda", "clip_text_encoder"):
        _bridge(getattr(port_sd, name), getattr(jax_sd, name))
    return jax_sd, port_sd


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(0)
    return {
        "x": rs.randn(1, 16, 16, 4).astype(np.float32),  # NHWC, as the JAX package takes it
        "clip_text_embedding": rs.randn(2, 77, 768).astype(np.float32),
    }


def _image(seed: int, size: int = 64) -> Image.Image:
    return Image.fromarray((np.random.RandomState(seed).rand(size, size, 3) * 255).astype(np.uint8))


def test_cfg_step_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """One denoising step: CFG batch 2 through the UNet, guidance 7.5, the DPM update."""
    jax_sd, port_sd = models
    emb = inputs["clip_text_embedding"]
    x = jnp.asarray(inputs["x"])
    # the JAX solver's stateful call keeps its history outside the pytree: run it eagerly
    noise = jax.jit(lambda sd, x, e: sd.predict_noise(x, 0, clip_text_embedding=e, condition_scale=7.5))(
        jax_sd, x, jnp.asarray(emb)
    )
    want = jax_sd.solver.rebuild(STEPS)(x, noise, 0)
    port_sd.solver = port_sd.solver.rebuild(STEPS)  # a fresh multistep history
    with torch.inference_mode():
        got = port_sd(torch.tensor(nhwc_to_nchw(inputs["x"])), 0, clip_text_embedding=torch.tensor(emb))
    assert got.shape == (1, 4, 16, 16)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= MODULE_TOL


def test_text_embedding_matches_jax(models: tuple[Any, StableDiffusion_1]) -> None:
    """The negative prompt's embedding first, then the prompt's."""
    jax_sd, port_sd = models
    want = np.asarray(jax_sd.compute_clip_text_embedding("a cute cat", negative_text="blurry"))
    with torch.inference_mode():
        got = port_sd.compute_clip_text_embedding("a cute cat", negative_text="blurry").numpy()
    assert got.shape == (2, 77, 768)
    assert _rel(got, want) <= MODULE_TOL


def test_slice_diffuse_and_decode_match_jax(
    models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]
) -> None:
    """The whole slice: 3 DPM++ steps (the multistep state carried by
    `diffuse`) with CFG 7.5, then the VAE decode."""
    jax_sd, port_sd = models
    emb = inputs["clip_text_embedding"]
    run = jax.jit(lambda sd, x, e: sd.lda.decode(sd.diffuse(x, clip_text_embedding=e, condition_scale=7.5)))
    want = np.asarray(run(jax_sd, jnp.asarray(inputs["x"]), jnp.asarray(emb)))
    with torch.inference_mode():
        latents = port_sd.diffuse(torch.tensor(nhwc_to_nchw(inputs["x"])), clip_text_embedding=torch.tensor(emb))
        got = port_sd.lda.decode(latents).numpy()
    assert got.shape == (1, 3, 128, 128)
    assert np.isfinite(got).all()
    assert _rel(nchw_to_nhwc(got), want) <= SLICE_TOL


def test_img2img_init_latents_match_jax(models: tuple[Any, StableDiffusion_1]) -> None:
    """img2img at strength 0.5: the image encoded, noised to the first
    inference step on given noise, scaled for the solver."""
    jax_sd, port_sd = models
    noise = np.random.RandomState(5).randn(1, 8, 8, 4).astype(np.float32)
    image = _image(6)
    first_step = round(0.5 * (STEPS - 1))
    try:
        jax_sd.set_inference_steps(STEPS, first_step=first_step)
        port_sd.set_inference_steps(STEPS, first_step=first_step)
        want = np.asarray(jax_sd.init_latents((64, 64), init_image=image, noise=jnp.asarray(noise)))
        with torch.inference_mode():
            got = port_sd.init_latents((64, 64), init_image=image, noise=torch.tensor(nhwc_to_nchw(noise)))
        assert port_sd.steps == [first_step, STEPS - 1] == jax_sd.steps
    finally:
        jax_sd.set_inference_steps(STEPS)
        port_sd.set_inference_steps(STEPS)
    assert got.shape == (1, 4, 8, 8)
    assert _rel(nchw_to_nhwc(got.numpy()), want) <= MODULE_TOL
    with torch.inference_mode():  # without an image: the noise, as the solver scales it
        fresh = port_sd.init_latents((64, 64), noise=torch.tensor(nhwc_to_nchw(noise)))
    assert torch.equal(fresh, torch.tensor(nhwc_to_nchw(noise)))


def test_inpainting_predict_noise_matches_jax(models: tuple[Any, StableDiffusion_1]) -> None:
    """A 9-channel UNet: the mask and the masked image's latents join the
    latents on the channel axis; the conditions and the CFG prediction."""
    jax_sd, port_sd = models
    jax_manual_seed(1)
    jax_model = JaxInpainting(
        unet=JaxSD1UNet(in_channels=9, base_channels=32), lda=jax_sd.lda,
        clip_text_encoder=jax_sd.clip_text_encoder, solver=JaxDPMSolver(num_inference_steps=STEPS),
    )  # fmt: skip
    port = StableDiffusion_1_Inpainting(
        unet=SD1UNet(in_channels=9, base_channels=32), lda=port_sd.lda,
        clip_text_encoder=port_sd.clip_text_encoder, solver=DPMSolver(num_inference_steps=STEPS), device="cpu",
    )  # fmt: skip
    _bridge(port.unet, jax_model.unet)
    target = _image(7)
    mask = Image.fromarray((np.indices((64, 64)).sum(0) // 32 % 2 * 255).astype(np.uint8), mode="L")
    jax_mask, jax_target = jax_model.set_inpainting_conditions(target, mask, latents_size=(8, 8))
    with torch.inference_mode():
        mask_latents, target_latents = port.set_inpainting_conditions(target, mask, latents_size=(8, 8))
    np.testing.assert_array_equal(nchw_to_nhwc(mask_latents.numpy()), np.asarray(jax_mask))
    assert _rel(nchw_to_nhwc(target_latents.numpy()), np.asarray(jax_target)) <= MODULE_TOL

    rs = np.random.RandomState(8)
    x, emb = rs.randn(1, 8, 8, 4).astype(np.float32), rs.randn(2, 77, 768).astype(np.float32)
    predict = jax.jit(lambda sd, x, e: sd.predict_noise(x, 1, clip_text_embedding=e, condition_scale=7.5))
    want = np.asarray(predict(jax_model, jnp.asarray(x), jnp.asarray(emb)))
    with torch.inference_mode():
        got = port.predict_noise(torch.tensor(nhwc_to_nchw(x)), 1, clip_text_embedding=torch.tensor(emb))
    assert got.shape == (1, 4, 8, 8)
    assert _rel(nchw_to_nhwc(got.numpy()), want) <= MODULE_TOL


def test_lcm_without_guidance_matches_jax(models: tuple[Any, StableDiffusion_1]) -> None:
    """LCM with no classifier-free guidance (one embedding, `condition_scale`
    unused): 4 steps, each re-noised with the JAX key's noise, handed to the
    port through `_renoising_noise`."""
    jax_sd, port_sd = models
    jax_lcm = JaxStableDiffusion_1(unet=jax_sd.unet, lda=jax_sd.lda, clip_text_encoder=jax_sd.clip_text_encoder,
                                   solver=JaxLCMSolver(num_inference_steps=4))  # fmt: skip
    port_lcm = StableDiffusion_1(unet=port_sd.unet, lda=port_sd.lda, clip_text_encoder=port_sd.clip_text_encoder,
                                 solver=LCMSolver(num_inference_steps=4), device="cpu")  # fmt: skip
    jax_lcm.classifier_free_guidance = port_lcm.classifier_free_guidance = False
    rs = np.random.RandomState(9)
    x0, emb = rs.randn(1, 8, 8, 4).astype(np.float32), rs.randn(1, 77, 768).astype(np.float32)
    keys = {step: jax.random.fold_in(jax.random.key(68), step) for step in jax_lcm.steps}
    noises = iter(np.asarray(jax.random.normal(keys[s], x0.shape)) for s in port_lcm.steps)
    port_lcm.solver._renoising_noise = lambda generator, shape: torch.tensor(nhwc_to_nchw(next(noises)))
    predict = jax.jit(lambda sd, x, step, e: sd.predict_noise(x, step, clip_text_embedding=e, condition_scale=1.0))
    want, got = jnp.asarray(x0), torch.tensor(nhwc_to_nchw(x0))
    for step in jax_lcm.steps:
        noise = predict(jax_lcm, want, step, jnp.asarray(emb))
        want = jax_lcm.solver(want, noise, step, key=keys[step])
        with torch.inference_mode():
            got = port_lcm(got, step, clip_text_embedding=torch.tensor(emb), condition_scale=1.0)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= SLICE_TOL


def test_num_images_matches_single_runs(models: tuple[Any, StableDiffusion_1]) -> None:
    """`num_images=2` denoises both latents in one batch ([uncond×2, cond×2]);
    each image equals a single run on its noise."""
    _, port_sd = models
    pipe = TextToImage(port_sd, size=(64, 64), num_images=2)
    images = pipe("a cute cat", negative_prompt="blurry", seed=3)
    assert isinstance(images, list) and len(images) == 2
    noise = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        emb = port_sd.compute_clip_text_embedding("a cute cat", negative_text="blurry")
        for i, image in enumerate(images):
            z = port_sd.diffuse(noise[i : i + 1], clip_text_embedding=emb, condition_scale=7.5)
            single = port_sd.lda.latents_to_image(z)
            diff = np.abs(np.asarray(image, dtype=np.int16) - np.asarray(single, dtype=np.int16))
            assert diff.max() <= 1, f"image {i}: {diff.max()} levels off the single run"  # float32 rounding flips
    assert isinstance(TextToImage(port_sd, size=(64, 64))("a cute cat", seed=3), Image.Image)


def test_full_width_keys_on_meta() -> None:
    """`StableDiffusion_1(device="meta")`: the full-width UNet's parameter
    count and the key set of the JAX model (the UNet's and the VAE's keys
    do not depend on the width; CLIP-L's taken at full width)."""
    jax_manual_seed(0)
    jax_keys = {f"unet.{k}" for k in JaxSD1UNet(in_channels=4, base_channels=32).state_dict()}
    jax_keys |= {f"lda.{k}" for k in JaxSD1Autoencoder().state_dict()}
    jax_keys |= {f"clip_text_encoder.{k}" for k in JaxCLIPTextEncoderL().state_dict()}
    port = StableDiffusion_1(device="meta")
    assert {p.device.type for p in port.parameters()} == {"meta"}
    assert sum(p.numel() for p in port.unet.parameters()) == SD1_UNET_PARAMETERS
    assert set(port.state_dict()) == jax_keys
    inpainting = StableDiffusion_1_Inpainting(device="meta")
    assert inpainting.unet.in_channels == 9
    assert sum(p.numel() for p in inpainting.unet.parameters()) == SD1_UNET_PARAMETERS + 5 * 320 * 9


def test_self_attention_guidance_is_not_ported(models: tuple[Any, StableDiffusion_1]) -> None:
    """Named when enabling self-attention guidance raised; it is ported now
    (`tests/test_torch_sd_zoo.py` holds it against JAX). Off by default;
    enabling injects one adapter around the UNet; disabling ejects it, and
    disabling again does nothing."""
    _, port_sd = models
    assert not port_sd.has_self_attention_guidance()
    port_sd.set_self_attention_guidance(True, scale=0.5)
    assert port_sd.has_self_attention_guidance() and port_sd.unet.parent is not None
    port_sd.set_self_attention_guidance(False)
    port_sd.set_self_attention_guidance(False)
    assert not port_sd.has_self_attention_guidance() and port_sd.unet.parent is None


def test_structural_copy_shares_weights_not_contexts(models: tuple[Any, StableDiffusion_1]) -> None:
    _, port_sd = models
    copy = port_sd.structural_copy()
    assert type(copy) is StableDiffusion_1 and copy.solver is port_sd.solver
    assert copy.unet is not port_sd.unet
    assert next(copy.unet.parameters()) is next(port_sd.unet.parameters())
    copy.unet.set_timestep(torch.zeros(1))
    assert copy.unet.use_context("diffusion") is not port_sd.unet.use_context("diffusion")
