"""The port against the committed golden images (`tests/e2e/golden/`).

The JAX package's golden tests (`tests/e2e/test_golden.py`) build their
models from a seed (`tests/e2e/golden_cfg.py`), run fixed prompts and noise
and hold the image to a committed PNG. Here the same JAX models are built,
their weights bridged into the port on the CPU, and the same prompts, noise
and steps run through the port, in the JAX tests' envelope: PSNR ≥ 35,
SSIM ≥ 0.98, DINOv2 cosine ≥ 0.99. The zoo goldens run full-width SD1.5
with the text encoder stubbed (the embeddings given), the adapters injected
in the port as in `golden_cfg`, so that the state dict keys line up.
"""

from __future__ import annotations

import gc
from typing import Any, Callable

import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.clip import CLIPImageEncoder, CLIPTextEncoder, ConceptExtender
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
from refiners_tpu_torch.foundationals.latent_diffusion import (
    Euler,
    LCMSolver,
    ModelPredictionType,
    ReferenceOnlyControlAdapter,
    Restart,
    SD1ControlnetAdapter,
    SD1ELLAAdapter,
    SD1IPAdapter,
    SD1T2IAdapter,
    SDFreeUAdapter,
    SolverParams,
    StableDiffusion_1_Inpainting,
    StyleAlignedAdapter,
    TimestepSpacing,
)
from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion, Size
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import (
    ICLight,
    SD1DiffusionTarget,
    SD1MultiDiffusion,
)
from tests.e2e import golden_cfg
from tests.e2e.golden_cfg import GOLDEN_DIR, build_sd15_full, build_sd15_reduced, build_sdxl_full, to_pil
from tests.utils import compute_psnr, ensure_similar_images, image_to_array

PROMPT, NEGATIVE = "a cute cat, best quality", "low quality, blurry"  # golden_cfg.run_sd15_*


def _bridge(port: Any, jax_model: Any) -> Any:
    """Load the JAX model's UNet, VAE and text encoder into the port's (strict), then drop the JAX model."""
    for name in ("unet", "lda", "clip_text_encoder"):
        state = getattr(jax_model, name).state_dict()
        load_jax_state_dict(getattr(port, name), {k: np.asarray(v) for k, v in state.items()})
    return port


def _check(name: str, image: torch.Tensor) -> None:
    """The envelope, and the PSNR printed (`pytest -s`)."""
    golden = Image.open(GOLDEN_DIR / f"{name}.png")
    got = to_pil(nchw_to_nhwc(image.numpy()))
    print(f"{name}: PSNR {compute_psnr(image_to_array(got), image_to_array(golden)):.2f} dB")
    ensure_similar_images(got, golden, min_psnr=35, min_ssim=0.98, min_dino_cosine=0.99)


def _sd15(sd: StableDiffusion_1, latent: int, scale_input: bool) -> torch.Tensor:
    """`golden_cfg.run_sd15_reduced` / `run_sd15_full` through the port."""
    noise = torch.tensor(nhwc_to_nchw(np.random.RandomState(0).randn(1, latent, latent, 4).astype(np.float32)))
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding(PROMPT, negative_text=NEGATIVE)
        x = sd.solver.scale_model_input(noise, step=-1) if scale_input else noise
        return sd.lda.decode(sd.diffuse(x, clip_text_embedding=emb, condition_scale=7.5))


def _sd15_reduced() -> StableDiffusion_1:
    """`build_sd15_reduced` in the port: SD1UNet(base_channels=32), a 2-layer CLIP-L, the full VAE, DDIM 10 steps."""
    return StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DDIM(num_inference_steps=10),
        device="cpu",
    )


def test_sd15_reduced_10step_golden() -> None:
    """`build_sd15_reduced`: SD1UNet(base_channels=32), a 2-layer CLIP-L, the
    full VAE, 10 DDIM steps at 128²."""
    port = _sd15_reduced()
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


def _sd15_stub_clip(steps: int = 10, solver: Any = None) -> StableDiffusion_1:
    """`golden_cfg._sd15_stub_clip` in the port: full-width SD1.5, 10 DDIM steps (or `solver`), no text encoder."""
    solver = solver if solver is not None else DDIM(num_inference_steps=steps)
    return StableDiffusion_1(solver=solver, clip_text_encoder=fl.Chain(fl.Identity()), device="cpu")


def _traj(
    sd: StableDiffusion_1,
    noise_seed: int = 50,
    emb_seed: int = 51,
    batch: int = 1,
    pre_step: Callable[[int], None] | None = None,
    per_step: Callable[[int, torch.Tensor], torch.Tensor] | None = None,
    scale: float = 7.5,
) -> torch.Tensor:
    """`golden_cfg._traj` through the port: 16×16 latents, CFG at `scale`,
    step by step (`pre_step` before and `per_step` after each), then the
    decode; a batch's images side by side, as the golden tiles them."""
    noise = np.random.RandomState(noise_seed).randn(batch, golden_cfg._LATENT, golden_cfg._LATENT, 4).astype(np.float32)
    emb = torch.tensor(np.random.RandomState(emb_seed).randn(2 * batch, 77, 768).astype(np.float32))
    x = torch.tensor(nhwc_to_nchw(noise))
    with torch.inference_mode():
        for step in sd.steps:
            if pre_step is not None:
                pre_step(step)
            x = sd(x, step, clip_text_embedding=emb, condition_scale=scale)
            if per_step is not None:
                x = per_step(step, x)
        image = sd.lda.decode(x)
    return torch.cat(list(image), dim=2)[None] if batch > 1 else image


def _condition(rs: np.random.RandomState) -> torch.Tensor:
    return torch.tensor(nhwc_to_nchw(rs.rand(1, 128, 128, 3).astype(np.float32)))


@pytest.mark.slow
def test_controlnet_10step_golden() -> None:
    """`build_controlnet`: one ControlNet, "canny", scale 1.0."""
    port = _sd15_stub_clip()
    adapter = SD1ControlnetAdapter(port.unet, name="canny").inject()
    jax_sd, _ = golden_cfg.build_controlnet()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    adapter.set_controlnet_condition(_condition(np.random.RandomState(52)))
    _check("controlnet_10step_128", _traj(port))


@pytest.mark.slow
def test_controlnet_stack_10step_golden() -> None:
    """`build_controlnet_stack`: "depth" at 0.3 injected first, then "canny" at 0.7."""
    port = _sd15_stub_clip()
    depth = SD1ControlnetAdapter(port.unet, name="depth", scale=0.3).inject()
    canny = SD1ControlnetAdapter(port.unet, name="canny", scale=0.7).inject()
    jax_sd, _, _ = golden_cfg.build_controlnet_stack()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    rs = np.random.RandomState(78)
    depth.set_controlnet_condition(_condition(rs))
    canny.set_controlnet_condition(_condition(rs))
    _check("controlnet_stack_10step_128", _traj(port, noise_seed=79, emb_seed=80))


@pytest.mark.slow
def test_t2i_adapter_10step_golden() -> None:
    """`build_t2i_adapter`: "pose" at 0.8; its condition encoder bridged apart (not a module of the UNet)."""
    port = _sd15_stub_clip()
    adapter = SD1T2IAdapter(port.unet, name="pose", scale=0.8).inject()
    jax_sd, jax_adapter = golden_cfg.build_t2i_adapter()
    _bridge(port, jax_sd)
    load_jax_state_dict(adapter.condition_encoder,
                        {k: np.asarray(v) for k, v in jax_adapter.condition_encoder.state_dict().items()})  # fmt: skip
    del jax_sd, jax_adapter
    gc.collect()
    with torch.inference_mode():
        adapter.set_condition_features(adapter.compute_condition_features(_condition(np.random.RandomState(54))))
    _check("t2i_adapter_10step_128", _traj(port))


@pytest.mark.slow
def test_freeu_10step_golden() -> None:
    """`build_freeu`: backbone scales (1.2, 1.4), skip scales (0.9, 0.2)."""
    port = _sd15_stub_clip()
    SDFreeUAdapter(port.unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    _bridge(port, golden_cfg.build_freeu())
    gc.collect()
    _check("freeu_10step_128", _traj(port))


def test_textual_inversion_10step_golden() -> None:
    """`build_textual_inversion`: the reduced SD1.5 with a concept,
    "<test-artwork>", added to its CLIP through `ConceptExtender`; the
    prompt uses it. Its text path is real, so this one is fast."""
    port = _sd15_reduced()
    extender = ConceptExtender(port.clip_text_encoder)
    extender.add_concept("<test-artwork>", torch.tensor(np.random.RandomState(64).randn(768).astype(np.float32)))
    extender.inject()
    _bridge(port, golden_cfg.build_textual_inversion())  # the added row too: Sum.EmbeddingExtender.new_weight
    noise = torch.tensor(nhwc_to_nchw(np.random.RandomState(65).randn(1, 16, 16, 4).astype(np.float32)))
    with torch.inference_mode():
        emb = port.compute_clip_text_embedding("a cute cat on a <test-artwork>", negative_text="low quality")
        image = port.lda.decode(port.diffuse(noise, clip_text_embedding=emb, condition_scale=7.5))
    _check("textual_inversion_10step_128", image)


@pytest.mark.slow
def test_sag_10step_golden() -> None:
    """`build_sag`: self-attention guidance at 0.75."""
    port = _sd15_stub_clip()
    port.set_self_attention_guidance(True, scale=0.75)
    _bridge(port, golden_cfg.build_sag())
    gc.collect()
    _check("sag_10step_128", _traj(port))


@pytest.mark.slow
def test_style_aligned_10step_golden() -> None:
    """`build_style_aligned`: StyleAligned at 0.8 on a batch of 2, the images side by side."""
    port = _sd15_stub_clip()
    StyleAlignedAdapter(port.unet, scale=0.8).inject()
    _bridge(port, golden_cfg.build_style_aligned())
    gc.collect()
    _check("style_aligned_10step_128", _traj(port, batch=2, noise_seed=55, emb_seed=56))


@pytest.mark.slow
def test_restart_10step_golden() -> None:
    """`build_restart`: Restart(num_steps=4, num_iterations=1) at its start
    step, its noise the JAX key's (`jax.random.key(57)`), injected."""
    import jax

    port = _sd15_stub_clip()
    jax_sd, _ = golden_cfg.build_restart()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    restart = Restart(ldm=port, num_steps=4, num_iterations=1)
    key = jax.random.key(57)
    shape = (1, golden_cfg._LATENT, golden_cfg._LATENT, 4)

    def jax_noise(generator: Any, _shape: tuple[int, ...], device: Any, iteration: int) -> torch.Tensor:
        return torch.tensor(nhwc_to_nchw(np.asarray(jax.random.normal(jax.random.fold_in(key, iteration), shape))))

    restart._restart_noise = jax_noise  # type: ignore[method-assign]
    emb = torch.tensor(np.random.RandomState(51).randn(2, 77, 768).astype(np.float32))

    def per_step(step: int, x: torch.Tensor) -> torch.Tensor:
        return restart(x, clip_text_embedding=emb, condition_scale=7.5) if step == restart.start_step else x

    _check("restart_10step_128", _traj(port, per_step=per_step))


def _refonly_pre_step(sd: StableDiffusion_1, adapter: ReferenceOnlyControlAdapter, g: np.random.RandomState,
                      nine: bool) -> Callable[[int], None]:  # fmt: skip
    """`golden_cfg.run_refonly`'s guide, noised each step (with `nine`, `run_inpainting_refonly`'s layout)."""
    guide = g.randn(1, golden_cfg._LATENT, golden_cfg._LATENT, 4).astype(np.float32)
    guide = torch.tensor(nhwc_to_nchw(np.concatenate([guide, guide])))
    noises = [torch.tensor(nhwc_to_nchw(g.randn(2, golden_cfg._LATENT, golden_cfg._LATENT, 4).astype(np.float32)))
              for _ in range(golden_cfg._STEPS)]  # fmt: skip

    def pre_step(step: int) -> None:
        noised = sd.solver.add_noise(guide, noises[step], step)
        if nine:
            noised = torch.cat([noised, torch.zeros_like(noised[:, :1]), guide], dim=1)
        adapter.set_controlnet_condition(noised)

    return pre_step


@pytest.mark.slow
def test_refonly_10step_golden() -> None:
    """`build_refonly`: reference-only control on a guide noised each step."""
    port = _sd15_stub_clip()
    adapter = ReferenceOnlyControlAdapter(port.unet).inject()
    jax_sd, _ = golden_cfg.build_refonly()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    _check("refonly_10step_128", _traj(port, pre_step=_refonly_pre_step(port, adapter, np.random.RandomState(59), False)))


@pytest.mark.slow
def test_inpainting_refonly_10step_golden() -> None:
    """`build_inpainting_refonly`: the 9-channel model, its mask and masked
    image set, and reference-only control on sd-webui's 9-channel guide."""
    port = StableDiffusion_1_Inpainting(solver=DDIM(num_inference_steps=10), clip_text_encoder=fl.Chain(fl.Identity()),
                                        device="cpu")  # fmt: skip
    adapter = ReferenceOnlyControlAdapter(port.unet).inject()
    jax_sd, _ = golden_cfg.build_inpainting_refonly()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    g = np.random.RandomState(81)
    target = Image.fromarray((g.rand(128, 128, 3) * 255).astype(np.uint8))
    mask = Image.fromarray((np.indices((128, 128)).sum(0) // 64 % 2 * 255).astype(np.uint8), mode="L")
    with torch.inference_mode():
        port.set_inpainting_conditions(target, mask, latents_size=(golden_cfg._LATENT, golden_cfg._LATENT))
    pre_step = _refonly_pre_step(port, adapter, g, True)
    _check("inpainting_refonly_10step_128", _traj(port, noise_seed=82, emb_seed=83, pre_step=pre_step))


@pytest.mark.slow
def test_ip_adapter_10step_golden() -> None:
    """`build_ip_adapter`: a stand-in encoder; the image tokens given (zeros as the negative)."""
    port = _sd15_stub_clip()
    encoder = fl.Chain()
    encoder.embedding_dim, encoder.output_dim = 1280, 1024  # type: ignore[attr-defined]
    adapter = SD1IPAdapter(port.unet, clip_image_encoder=encoder).inject()  # type: ignore[arg-type]
    jax_sd, _ = golden_cfg.build_ip_adapter()
    _bridge(port, jax_sd)  # the image keys' and values' projections are the UNet's after injection
    del jax_sd
    gc.collect()
    tokens = np.random.RandomState(53).randn(1, 4, 768).astype(np.float32)
    adapter.set_clip_image_embedding(torch.tensor(np.concatenate([np.zeros_like(tokens), tokens])))
    _check("ip_adapter_10step_128", _traj(port))


@pytest.mark.slow
def test_ip_adapter_plus_10step_golden() -> None:
    """`build_ip_adapter_plus`: a reduced CLIP image encoder's grid features
    through the perceiver resampler, both bridged apart (not modules of the UNet)."""
    port = _sd15_stub_clip()
    encoder = CLIPImageEncoder(image_size=32, embedding_dim=64, output_dim=48, patch_size=16, num_layers=32,
                               num_attention_heads=4, feedforward_dim=128)  # fmt: skip
    adapter = SD1IPAdapter(port.unet, clip_image_encoder=encoder, fine_grained=True).inject()
    jax_sd, jax_adapter = golden_cfg.build_ip_adapter_plus()
    _bridge(port, jax_sd)
    for name in ("clip_image_encoder", "image_proj"):
        state = getattr(jax_adapter, name).state_dict()
        load_jax_state_dict(getattr(adapter, name), {k: np.asarray(v) for k, v in state.items()})
    del jax_sd, jax_adapter
    gc.collect()
    image = torch.tensor(nhwc_to_nchw(np.random.RandomState(75).randn(1, 32, 32, 3).astype(np.float32)))
    with torch.inference_mode():
        adapter.set_clip_image_embedding(adapter.compute_clip_image_embedding(image))
    _check("ip_adapter_plus_10step_128", _traj(port, noise_seed=76, emb_seed=77))


@pytest.mark.slow
def test_ella_10step_golden() -> None:
    """`build_ella`: `SD1ELLAAdapter` (its encoder damped ×0.2, as there) on
    a 12-token LLM embedding, also ×0.2; ELLA's keys are the UNet's after
    injection, so the bridge carries them."""
    port = _sd15_stub_clip()
    adapter = SD1ELLAAdapter(port.unet).inject()
    jax_sd, _ = golden_cfg.build_ella()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    adapter.set_llm_text_embedding(torch.tensor(0.2 * np.random.RandomState(58).randn(2, 12, 2048).astype(np.float32)))
    _check("ella_10step_128", _traj(port))


@pytest.mark.slow
def test_ic_light_10step_golden() -> None:
    """`build_ic_light`: `ICLight` from a zero patch, then JAX's patched
    UNet bridged (conv_in of 8 channels); the condition a gray composite,
    CFG 2.0."""
    unet = SD1UNet(in_channels=4)
    zero = {k: torch.zeros(v.shape) for k, v in unet.state_dict().items()}
    zero["DownBlocks.Chain_1.Conv2d.weight"] = torch.zeros((320, 8, 3, 3))  # OIHW: 8 input channels
    port = ICLight(patch_weights=zero, unet=unet, lda=SD1Autoencoder(), clip_text_encoder=fl.Chain(fl.Identity()),
                   solver=DDIM(num_inference_steps=10), device="cpu")  # fmt: skip
    _bridge(port, golden_cfg.build_ic_light())
    gc.collect()
    g = np.random.RandomState(61)
    image = Image.fromarray((g.rand(128, 128, 3) * 255).astype(np.uint8))
    mask = Image.fromarray((np.indices((128, 128)).sum(0) % 2 * 255).astype(np.uint8), mode="L")
    with torch.inference_mode():
        port.set_ic_light_condition(ICLight.compute_gray_composite(image=image, mask=mask))
    _check("ic_light_10step_128", _traj(port, scale=2.0, noise_seed=62, emb_seed=63))


@pytest.mark.slow
def test_multi_diffusion_4step_golden() -> None:
    """`build_multi_diffusion`: two 16² tiles over 16 × 24 latents, each with its own DDIM, 4 steps."""
    port = _sd15_stub_clip(steps=4)
    jax_sd, _, _ = golden_cfg.build_multi_diffusion()
    _bridge(port, jax_sd)
    del jax_sd
    gc.collect()
    md = SD1MultiDiffusion(port)
    emb = torch.tensor(np.random.RandomState(72).randn(2, 77, 768).astype(np.float32))
    targets = [SD1DiffusionTarget(tile=t, solver=DDIM(num_inference_steps=4), clip_text_embedding=emb)
               for t in MultiDiffusion.generate_latent_tiles(size=Size(16, 24), tile_size=Size(16, 16))]  # fmt: skip
    noise = torch.tensor(nhwc_to_nchw(np.random.RandomState(73).randn(1, 16, 24, 4).astype(np.float32)))
    x = noise
    with torch.inference_mode():
        for step in port.steps:
            x = md(x, noise=noise, step=step, targets=targets)
        image = port.lda.decode(x)
    _check("multi_diffusion_4step_128", image)


@pytest.mark.slow
def test_lcm_4step_golden() -> None:
    """`build_lcm`: `LCMSolver` 4 steps at CFG 1.5, re-noised between steps
    with the JAX key's noise (`fold_in(key(68), step)`), injected through
    `_renoising_noise`."""
    import jax

    port = _sd15_stub_clip(solver=LCMSolver(num_inference_steps=4))
    _bridge(port, golden_cfg.build_lcm())
    gc.collect()
    shape = (1, golden_cfg._LATENT, golden_cfg._LATENT, 4)
    noises = iter([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(68), step), shape))
                   for step in port.steps])  # fmt: skip
    port.solver._renoising_noise = lambda generator, _shape: torch.tensor(nhwc_to_nchw(next(noises)))  # type: ignore[method-assign]
    _check("lcm_4step_128", _traj(port, scale=1.5, noise_seed=66, emb_seed=67))


@pytest.mark.slow
def test_inpainting_10step_golden() -> None:
    """`build_inpainting`: the 9-channel model, a checkerboard mask of 64² squares, 10 DDIM steps."""
    port = StableDiffusion_1_Inpainting(solver=DDIM(num_inference_steps=10), clip_text_encoder=fl.Chain(fl.Identity()),
                                        device="cpu")  # fmt: skip
    _bridge(port, golden_cfg.build_inpainting())
    gc.collect()
    g = np.random.RandomState(69)
    target = Image.fromarray((g.rand(128, 128, 3) * 255).astype(np.uint8))
    mask = Image.fromarray((np.indices((128, 128)).sum(0) // 64 % 2 * 255).astype(np.uint8), mode="L")
    with torch.inference_mode():
        port.set_inpainting_conditions(target, mask, latents_size=(golden_cfg._LATENT, golden_cfg._LATENT))
    _check("inpainting_10step_128", _traj(port, noise_seed=70, emb_seed=71))


@pytest.mark.slow
def test_lightning_4step_golden() -> None:
    """`build_lightning_4step`: full-width SDXL, 4 trailing Euler steps, no CFG."""
    params = SolverParams(timesteps_spacing=TimestepSpacing.TRAILING, model_prediction_type=ModelPredictionType.NOISE)
    port = StableDiffusion_XL(unet=SDXLUNet(in_channels=4), lda=SDXLAutoencoder(), clip_text_encoder=fl.Chain(fl.Identity()),
                              solver=Euler(num_inference_steps=4, params=params), device="cpu")  # fmt: skip
    port.classifier_free_guidance = False
    _bridge(port, golden_cfg.build_lightning_4step())
    gc.collect()
    rs = np.random.RandomState(84)
    emb = torch.tensor(rs.randn(1, 77, 2048).astype(np.float32))
    pooled = torch.tensor(rs.randn(1, 1280).astype(np.float32))
    noise = torch.tensor(nhwc_to_nchw(rs.randn(1, golden_cfg._LATENT, golden_cfg._LATENT, 4).astype(np.float32)))
    with torch.inference_mode():
        x = port.solver.scale_model_input(noise, step=-1)
        for step in port.steps:
            x = port(x, step, clip_text_embedding=emb, pooled_text_embedding=pooled, time_ids=port.default_time_ids)
        image = port.lda.decode(x)
    _check("lightning_4step_128", image)
