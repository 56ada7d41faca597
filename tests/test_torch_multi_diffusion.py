"""The port's MultiDiffusion, tiled VAE and MultiUpscaler against the JAX
package, on the CPU.

The tile planners (`MultiDiffusion.generate_latent_tiles`, the VAE's
`_generate_latent_tiles`) and the blending mask on grids of sizes; the full
SD1 VAE's tiled encode and decode inside `tiled_inference` (every GroupNorm
a `FixedGroupNorm`, statistics frozen from the downscaled pass) on a 64 × 48
image in 32² tiles; `SD1MultiDiffusion` over three targets (two DPM++ tiles,
each with its own multistep history, and an img2img target with an opacity
mask and a later start) on the JAX tests' reduced SD1.5; `MultiUpscaler.upscale`
end to end on the reduced SD1.5 (2-layer CLIP-L, full VAE) read from
safetensors files, two LoRAs and a negative embedding from files, JAX's
noise injected through `MultiUpscaler._upscale_noise`. The full-width tile
ControlNet is held in `test_multi_upscaler_with_the_tile_controlnet_matches_jax`
(`-m slow`); the fast test gives both packages a stand-in that records each
tile's condition. Float32: 1e-4 relative; tiles, masks' ones and the
ejected VAE exactly.
"""

from __future__ import annotations

import gc
from pathlib import Path
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.fluxion.utils import save_to_safetensors as jax_save_to_safetensors
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import DPMSolver as JaxDPMSolver
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion import auto_encoder as jax_auto_encoder
from refiners_tpu.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion as JaxMultiDiffusion
from refiners_tpu.foundationals.latent_diffusion.multi_diffusion import Size as JaxSize
from refiners_tpu.foundationals.latent_diffusion.multi_diffusion import Tile as JaxTile
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import multi_upscaler as jax_multi_upscaler
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.multi_diffusion import (
    SD1DiffusionTarget as JaxSD1DiffusionTarget,
)
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.multi_diffusion import (
    SD1MultiDiffusion as JaxSD1MultiDiffusion,
)
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.fluxion.utils import save_to_safetensors
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DPMSolver,
    MultiDiffusion,
    SD1Autoencoder,
    SD1UNet,
    StableDiffusion_1,
)
from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import (
    FixedGroupNorm,
    LatentDiffusionAutoencoder,
    _create_blending_mask,
    _ImageSize,
)
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import Size, Tile
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import (
    MultiUpscaler,
    SD1DiffusionTarget,
    SD1MultiDiffusion,
    UpscalerCheckpoints,
)

TOL = 1e-4
PROMPT, NEGATIVE = "a cute cat, best quality", "low quality, blurry"
LORA_RANK = 4


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


def _image(width: int, height: int, seed: int) -> Image.Image:
    return Image.fromarray((np.random.RandomState(seed).rand(height, width, 3) * 255).astype(np.uint8))


# -- tile planners and the blending mask --------------------------------------------------

SIZES = [(16, 24), (24, 16), (64, 64), (64, 128), (192, 192), (100, 36), (17, 33), (144, 112), (8, 8)]
TILES = [(8, 8), (16, 16), (64, 64), (144, 112), (12, 20)]


@pytest.mark.parametrize("min_overlap", [0, 4, 8])
def test_generate_latent_tiles_matches_jax(min_overlap: int) -> None:
    for size in SIZES:
        for tile in TILES:
            if min_overlap >= min(tile):
                continue
            got = MultiDiffusion.generate_latent_tiles(Size(*size), Size(*tile), min_overlap=min_overlap)
            want = JaxMultiDiffusion.generate_latent_tiles(JaxSize(*size), JaxSize(*tile), min_overlap=min_overlap)
            assert [tuple(t) for t in got] == [tuple(t) for t in want], (size, tile)
            assert all(isinstance(t, Tile) for t in got)
    # the upscaler's default at 1536²: four tiles of 144 × 112 over 192 × 192 latents
    tiles = MultiDiffusion.generate_latent_tiles(Size(192, 192), Size(144, 112), min_overlap=8)
    assert tiles == [Tile(0, 0, 144, 112), Tile(0, 80, 144, 192), Tile(48, 0, 192, 112), Tile(48, 80, 192, 192)]


@pytest.mark.parametrize("overlap", [2, 8, 16])
def test_vae_latent_tiles_match_jax(overlap: int) -> None:
    for size in SIZES:
        for tile in TILES:
            if overlap >= min(tile):
                continue
            got = LatentDiffusionAutoencoder._generate_latent_tiles(_ImageSize(*size), _ImageSize(*tile), overlap)
            want = jax_auto_encoder.LatentDiffusionAutoencoder._generate_latent_tiles(
                jax_auto_encoder._ImageSize(*size), jax_auto_encoder._ImageSize(*tile), overlap
            )
            assert [tuple(t) for t in got] == [tuple(t) for t in want], (size, tile)
    # the tiled VAE's at 1536² (tiles of 1024 px, blending 64): 128², 128 × 72, 72 × 128 and 72² latents
    tiles = LatentDiffusionAutoencoder._generate_latent_tiles(_ImageSize(192, 192), _ImageSize(128, 128), 8)
    assert [(t.bottom - t.top) * (t.right - t.left) for t in tiles] == [16384, 9216, 9216, 5184]


@pytest.mark.parametrize("blending", [0, 3, 8, 64])
def test_blending_mask_matches_jax(blending: int) -> None:
    for height, width in [(16, 16), (12, 20), (128, 72), (5, 9)]:
        for is_edge in [(False,) * 4, (True, False, True, False), (False, True, False, True), (True,) * 4]:
            got = _create_blending_mask(_ImageSize(height, width), blending, 3, is_edge).numpy()
            want = np.asarray(jax_auto_encoder._create_blending_mask(jax_auto_encoder._ImageSize(height, width),
                                                                     blending, 3, is_edge))  # fmt: skip
            want = np.broadcast_to(nhwc_to_nchw(want), (1, want.shape[-1], height, width))
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7)  # the ramps' linspace: up to 2 float32 ulps at 1
            np.testing.assert_array_equal(got == 1.0, want == 1.0)


# -- the tiled VAE ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vaes() -> tuple[Any, SD1Autoencoder]:
    jax_manual_seed(30)
    jax_vae, vae = JaxSD1Autoencoder(), SD1Autoencoder()
    _bridge(vae, jax_vae)
    return jax_vae, vae


def test_tiled_methods_require_the_context(vaes: tuple[Any, SD1Autoencoder]) -> None:
    _, vae = vaes
    with pytest.raises(ValueError, match="context manager not active"):
        vae.tiled_image_to_latents(_image(64, 64, 1))
    with pytest.raises(ValueError, match="context manager not active"):
        vae.tiled_latents_to_image(torch.zeros((1, 4, 8, 8)))


def test_tiled_encode_and_decode_match_jax(vaes: tuple[Any, SD1Autoencoder]) -> None:
    """A 64 × 48 image in tiles of 32² (blending 16: six tiles of ≤ 4 × 4
    latents, two latents of overlap): the latents, the decoded pixels
    before quantization and the image; the frozen statistics; after the
    context, the VAE's weights and its decode bit for bit as before."""
    jax_vae, vae = vaes
    image = _image(64, 48, 31)
    z = np.random.RandomState(32).randn(1, 6, 8, 4).astype(np.float32)
    with torch.inference_mode():
        before_state = {k: v.clone() for k, v in vae.state_dict().items()}
        before_decode = vae.decode(torch.tensor(nhwc_to_nchw(z)))
    n_group_norms = sum(1 for _ in vae.layers(fl.GroupNorm, recurse=True))
    with jax_vae.tiled_inference(image, tile_size=(32, 32), blending=16):
        want_latents = np.asarray(jax_vae.tiled_image_to_latents(image))
        want_pixels = np.asarray(jax_vae._tiled_decode(jnp.asarray(want_latents), jax_vae._tile_size, 16))
        want_image = np.asarray(jax_vae.tiled_latents_to_image(jnp.asarray(want_latents)))
    with torch.inference_mode(), vae.tiled_inference(image, tile_size=(32, 32), blending=16):
        fixed = list(vae.layers(FixedGroupNorm, recurse=True))
        assert len(fixed) == n_group_norms > 0 and all(isinstance(f.target, fl.GroupNorm) for f in fixed)
        assert all(f.mean is not None and f.mean.shape == (1, 32, 1, 1, 1) for f in fixed)
        latents = vae.tiled_image_to_latents(image)
        port_latents = torch.tensor(nhwc_to_nchw(want_latents))
        pixels = vae._tiled_decode(port_latents, vae._tile_size, 16)
        got_image = np.asarray(vae.tiled_latents_to_image(port_latents))
    assert latents.shape == (1, 4, 6, 8) and _rel(nchw_to_nhwc(latents.numpy()), want_latents) <= TOL
    assert pixels.shape == (1, 3, 48, 64) and _rel(nchw_to_nhwc(pixels.numpy()), want_pixels) <= TOL
    assert np.abs(got_image.astype(int) - want_image.astype(int)).max() <= 1
    # the frozen statistics are the downscaled pass's: an untiled decode differs
    with torch.inference_mode():
        assert _rel(vae.decode(port_latents).numpy(), pixels.numpy()) > 1e-3
    assert not any(True for _ in vae.layers(FixedGroupNorm, recurse=True))
    assert sum(1 for _ in vae.layers(fl.GroupNorm, recurse=True)) == n_group_norms
    assert vae._tile_size is None and vae._blending is None
    with torch.inference_mode():
        assert all(torch.equal(v, before_state[k]) for k, v in vae.state_dict().items())
        assert torch.equal(vae.decode(torch.tensor(nhwc_to_nchw(z))), before_decode)


# -- SD1MultiDiffusion ----------------------------------------------------------------------


def _stub() -> Any:
    return fl.Chain(fl.Identity())


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_1]:
    """The reduced SD1.5 (text encoder stubbed) in both packages."""
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_1(unet=JaxSD1UNet(in_channels=4, base_channels=32), lda=JaxSD1Autoencoder(),
                                  clip_text_encoder=jfl.Chain(jfl.Identity()), solver=JaxDDIM(num_inference_steps=4))  # fmt: skip
    sd = StableDiffusion_1(unet=SD1UNet(in_channels=4, base_channels=32), lda=SD1Autoencoder(), clip_text_encoder=_stub(),
                           solver=DDIM(num_inference_steps=4), device="cpu")  # fmt: skip
    _bridge(sd.unet, jax_sd.unet)
    return jax_sd, sd


def test_sd1_multi_diffusion_matches_jax(models: tuple[Any, StableDiffusion_1]) -> None:
    """Two DPM++ tiles of 16² over 16 × 24 latents (overlap 8), each with
    its own solver, and a third target from step 1: init latents noised
    there, an opacity mask, weight 2, its own text and scale. Two steps:
    the second is DPM++'s second-order one, which reads each tile's own
    previous estimate."""
    jax_sd, sd = models
    rs = np.random.RandomState(33)
    emb, emb2 = rs.randn(2, 77, 768).astype(np.float32), rs.randn(2, 77, 768).astype(np.float32)
    x = rs.randn(1, 16, 24, 4).astype(np.float32)
    noise = rs.randn(1, 16, 24, 4).astype(np.float32)
    init = rs.randn(1, 8, 8, 4).astype(np.float32)
    opacity = rs.rand(1, 8, 8, 1).astype(np.float32)
    tiles = MultiDiffusion.generate_latent_tiles(Size(16, 24), Size(16, 16))
    assert tiles == [Tile(0, 0, 16, 16), Tile(0, 8, 16, 24)]
    extra = Tile(4, 12, 12, 20)

    jax_md = JaxSD1MultiDiffusion(jax_sd)
    jax_targets = [JaxSD1DiffusionTarget(tile=JaxTile(*t), solver=JaxDPMSolver(num_inference_steps=4),
                                         clip_text_embedding=jnp.asarray(emb)) for t in tiles]  # fmt: skip
    jax_targets.append(JaxSD1DiffusionTarget(tile=JaxTile(*extra), solver=JaxDDIM(num_inference_steps=4),
                                             clip_text_embedding=jnp.asarray(emb2), condition_scale=5.0, weight=2,
                                             start_step=1, init_latents=jnp.asarray(init),
                                             opacity_mask=jnp.asarray(opacity)))  # fmt: skip
    md = SD1MultiDiffusion(sd)
    targets = [SD1DiffusionTarget(tile=t, solver=DPMSolver(num_inference_steps=4), clip_text_embedding=torch.tensor(emb))
               for t in tiles]  # fmt: skip
    targets.append(SD1DiffusionTarget(tile=extra, solver=DDIM(num_inference_steps=4), clip_text_embedding=torch.tensor(emb2),
                                      condition_scale=5.0, weight=2, start_step=1,
                                      init_latents=torch.tensor(nhwc_to_nchw(init)),
                                      opacity_mask=torch.tensor(nhwc_to_nchw(opacity))))  # fmt: skip
    solver = sd.solver
    jx, px = jnp.asarray(x), torch.tensor(nhwc_to_nchw(x))
    for step in (0, 1):
        jx = jax_md(jx, noise=jnp.asarray(noise), step=step, targets=jax_targets)
        with torch.inference_mode():
            px = md(px, noise=torch.tensor(nhwc_to_nchw(noise)), step=step, targets=targets)
        assert _rel(nchw_to_nhwc(px.numpy()), np.asarray(jx)) <= TOL, step
    assert sd.solver is solver  # the model's own solver is restored after each target
    assert all(len(t.solver.estimated_data) == 2 and t.solver.estimated_data[-1].shape == (1, 4, 16, 16)
               for t in targets[:2])  # fmt: skip
    assert not torch.equal(targets[0].solver.estimated_data[-1], targets[1].solver.estimated_data[-1])


# -- MultiUpscaler ----------------------------------------------------------------------------


class _ConditionRecorder:
    """Stands in for the tile ControlNet: its scales, and the conditions each tile sets."""

    def __init__(self) -> None:
        self.scale, self.scale_decay, self.conditions = 1.0, 1.0, []

    def set_controlnet_condition(self, condition: Any) -> None:
        self.conditions.append(np.asarray(condition))


def _lora_file(path: Path, sd: StableDiffusion_1, seed: int) -> Path:
    """A CivitAI-style LoRA (reference layout) for every Linear of the
    UNet's transformer blocks and of CLIP, keyed in the order of the tree."""
    rs = np.random.RandomState(seed)
    unet = [l for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    tensors = {}
    for prefix, linears in (("lora_unet", unet), ("lora_te_text_model", list(sd.clip_text_encoder.layers(fl.Linear, recurse=True)))):
        for n, linear in enumerate(linears):
            tensors[f"{prefix}_{n:04d}.lora_down.weight"] = torch.tensor(0.1 * rs.randn(LORA_RANK, linear.in_features), dtype=torch.float32)
            tensors[f"{prefix}_{n:04d}.lora_up.weight"] = torch.tensor(0.1 * rs.randn(linear.out_features, LORA_RANK), dtype=torch.float32)
    save_to_safetensors(path, tensors)
    return path


def _reduced(cls: Any, build_sd: Callable[[], Any], stub_controlnet: bool) -> Any:
    """The upscaler `cls` with `load_stable_diffusion` building `build_sd()`
    (the test's sizes) and reading its files, and with the ControlNet stood
    in for by a recorder when `stub_controlnet`."""

    class Reduced(cls):
        def load_stable_diffusion(self, checkpoints: Any) -> Any:
            sd = build_sd()
            sd.unet.load_from_safetensors(checkpoints.unet)
            sd.clip_text_encoder.load_from_safetensors(checkpoints.clip_text_encoder)
            sd.lda.load_from_safetensors(checkpoints.lda)
            return sd

        def load_controlnet(self, checkpoints: Any) -> Any:
            return _ConditionRecorder() if stub_controlnet else super().load_controlnet(checkpoints)

    return Reduced


def _upscalers(tmp_path: Path, full_unet: bool) -> tuple[Any, MultiUpscaler]:
    """The upscaler in both packages from files: the reduced SD1.5 (or a
    full-width UNet with the tile ControlNet), two LoRAs and a (4, 768)
    negative embedding."""
    jax_manual_seed(40)
    clip_kwargs = dict(embedding_dim=768, num_layers=2, num_attention_heads=12)
    unet_kwargs = {} if full_unet else {"base_channels": 32}
    jax_parts = {"unet": JaxSD1UNet(in_channels=4, **unet_kwargs), "clip": JaxCLIPTextEncoder(**clip_kwargs),
                 "lda": JaxSD1Autoencoder()}  # fmt: skip
    port_parts = {"unet": SD1UNet(in_channels=4, **unet_kwargs), "clip": CLIPTextEncoder(**clip_kwargs),
                  "lda": SD1Autoencoder()}  # fmt: skip
    files: dict[str, dict[str, Path]] = {"jax": {}, "port": {}}
    for name in jax_parts:
        _bridge(port_parts[name], jax_parts[name])
        files["jax"][name], files["port"][name] = tmp_path / f"{name}.jax.safetensors", tmp_path / f"{name}.safetensors"
        jax_save_to_safetensors(files["jax"][name], jax_parts[name].state_dict())
        save_to_safetensors(files["port"][name], port_parts[name].state_dict())
    if full_unet:
        from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.controlnet import Controlnet as JaxControlnet

        from refiners_tpu_torch.foundationals.latent_diffusion import Controlnet

        jax_manual_seed(41)
        jax_cn, cn = JaxControlnet(name="tile"), Controlnet(name="tile")
        _bridge(cn, jax_cn)
        for package in ("jax", "port"):
            files[package]["controlnet"] = tmp_path / f"controlnet.{package}.safetensors"
        jax_save_to_safetensors(files["jax"]["controlnet"], jax_cn.state_dict())
        save_to_safetensors(files["port"]["controlnet"], cn.state_dict())
        del jax_cn, cn
    del jax_parts
    gc.collect()
    port_sd = StableDiffusion_1(unet=port_parts["unet"], lda=port_parts["lda"], clip_text_encoder=port_parts["clip"],
                                device="cpu")  # fmt: skip
    loras = {name: _lora_file(tmp_path / f"{name}.safetensors", port_sd, seed) for name, seed in (("style", 42), ("detail", 43))}
    del port_sd, port_parts
    save_to_safetensors(tmp_path / "negative.safetensors",
                        {"emb": torch.tensor(0.5 * np.random.RandomState(44).randn(4, 768), dtype=torch.float32)})  # fmt: skip

    def checkpoints(package: str, cls: Any) -> Any:
        return cls(unet=files[package]["unet"], clip_text_encoder=files[package]["clip"], lda=files[package]["lda"],
                   controlnet_tile=files[package].get("controlnet", tmp_path / "none"), loras=loras,
                   negative_embedding=tmp_path / "negative.safetensors", negative_embedding_key="emb")  # fmt: skip

    jax_cls = _reduced(jax_multi_upscaler.MultiUpscaler, lambda: JaxStableDiffusion_1(
        unet=JaxSD1UNet(in_channels=4, **unet_kwargs), lda=JaxSD1Autoencoder(), clip_text_encoder=JaxCLIPTextEncoder(**clip_kwargs),
        solver=JaxDPMSolver(num_inference_steps=4)), stub_controlnet=not full_unet)  # fmt: skip
    cls = _reduced(MultiUpscaler, lambda: StableDiffusion_1(
        unet=SD1UNet(in_channels=4, **unet_kwargs), lda=SD1Autoencoder(), clip_text_encoder=CLIPTextEncoder(**clip_kwargs),
        solver=DPMSolver(num_inference_steps=4), device="cpu"), stub_controlnet=not full_unet)  # fmt: skip
    jax_upscaler = jax_cls(checkpoints("jax", jax_multi_upscaler.UpscalerCheckpoints))
    upscaler = cls(checkpoints("port", UpscalerCheckpoints), device="cpu")
    return jax_upscaler, upscaler


def _upscale_both(jax_upscaler: Any, upscaler: MultiUpscaler, **kwargs: Any) -> dict[str, Any]:
    """`upscale` of a 96 × 64 image ×2 in both packages, JAX's noise
    injected into the port; the latents each tiled decode receives and the
    pixels it returns (before quantization), and the images."""
    key = jax.random.key(45)
    latents: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {"jax": [], "port": []}
    jax_decode, decode = jax_upscaler.sd.lda._tiled_decode, upscaler.sd.lda._tiled_decode

    def jax_recorded(x: Any, *args: Any) -> Any:
        out = jax_decode(x, *args)
        latents["jax"].append((np.asarray(x), np.asarray(out)))
        return out

    def recorded(x: torch.Tensor, *args: Any) -> torch.Tensor:
        out = decode(x, *args)
        latents["port"].append((nchw_to_nhwc(x.numpy()), nchw_to_nhwc(out.numpy())))
        return out

    def jax_noise(generator: Any, shape: tuple[int, ...]) -> torch.Tensor:
        b, c, h, w = shape
        return torch.tensor(nhwc_to_nchw(np.asarray(jax.random.normal(key, (b, h, w, c), dtype=jnp.float32))))

    jax_upscaler.sd.lda._tiled_decode, upscaler.sd.lda._tiled_decode = jax_recorded, recorded
    upscaler._upscale_noise = jax_noise  # type: ignore[method-assign]
    image = _image(96, 64, 46)
    args = dict(prompt=PROMPT, negative_prompt=NEGATIVE, tile_size=(16, 16), num_inference_steps=4,
                denoise_strength=0.5, autoencoder_tile_length=128, loras_scale={"style": 1.0, "detail": 0.5}, **kwargs)  # fmt: skip
    want = jax_upscaler.upscale(image, key=key, **args)
    got = upscaler.upscale(image, **args)
    return {"jax": want, "port": got, "latents": latents}


def test_multi_upscaler_matches_jax(tmp_path: Path) -> None:
    """The reduced SD1.5 from safetensors, two LoRAs at 1.0 / 0.5, a
    negative embedding, DPM++ 4 steps from step 2: two MultiDiffusion tiles
    of 16² over 16 × 24 latents, the tiled VAE in 128² tiles (two)."""
    jax_upscaler, upscaler = _upscalers(tmp_path, full_unet=False)
    assert upscaler.negative_embedding_token == ", <0> <1> <2> <3> " == jax_upscaler.negative_embedding_token
    assert upscaler.manager is not None and sorted(upscaler.manager.names) == ["detail", "style"]
    with torch.inference_mode():
        emb = upscaler.compute_clip_text_embedding(PROMPT, NEGATIVE).numpy()
    assert _rel(emb, np.asarray(jax_upscaler.compute_clip_text_embedding(PROMPT, NEGATIVE))) <= TOL
    out = _upscale_both(jax_upscaler, upscaler)
    assert out["port"].size == out["jax"].size == (192, 128)
    ((want, want_pixels),), ((got, pixels),) = out["latents"]["jax"], out["latents"]["port"]
    assert got.shape == (1, 16, 24, 4) and _rel(got, want) <= TOL
    assert pixels.shape == (1, 128, 192, 3) and _rel(pixels, want_pixels) <= TOL
    # each tile's condition: its crop of the pre-upscaled image, set once a step
    jax_cn, cn = jax_upscaler.controlnet, upscaler.controlnet
    assert (upscaler.controlnet.scale, upscaler.controlnet.scale_decay) == (0.6, 0.825)
    assert len(cn.conditions) == len(jax_cn.conditions) == 4
    for got_c, want_c in zip(cn.conditions, jax_cn.conditions):
        np.testing.assert_array_equal(nchw_to_nhwc(got_c), want_c)
    # the VAE is itself again after the upscale
    assert not any(True for _ in upscaler.sd.lda.layers(FixedGroupNorm, recurse=True))
    assert isinstance(upscaler.sd.solver, DPMSolver) and upscaler.sd.solver.first_inference_step == 2


def test_multi_upscaler_builds_on_the_card_by_default(tmp_path: Path) -> None:
    """With no device the upscaler builds its SD1.5 on `cuda`; with no card,
    building raises before any file is read."""
    missing = tmp_path / "missing.safetensors"
    checkpoints = UpscalerCheckpoints(unet=missing, clip_text_encoder=missing, lda=missing, controlnet_tile=missing)
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 10 builds the upscaler there")
    with pytest.raises((RuntimeError, AssertionError)):
        MultiUpscaler(checkpoints)


@pytest.mark.slow
def test_multi_upscaler_with_the_tile_controlnet_matches_jax(tmp_path: Path) -> None:
    """As the fast test, with a full-width UNet and the full-width tile
    ControlNet (scale 0.6, decay 0.825) read from files in both packages."""
    jax_upscaler, upscaler = _upscalers(tmp_path, full_unet=True)
    assert upscaler.controlnet.controlnet.name == "tile"
    out = _upscale_both(jax_upscaler, upscaler)
    ((want, want_pixels),), ((got, pixels),) = out["latents"]["jax"], out["latents"]["port"]
    assert _rel(got, want) <= TOL and _rel(pixels, want_pixels) <= TOL
