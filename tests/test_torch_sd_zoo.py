"""The port's SD1.5 guidance adapters against the JAX package, on the CPU.

Self-attention guidance (on text-to-image, beside an IP-Adapter, and on
inpainting), StyleAligned, reference-only control (4- and 9-channel UNets,
and beside a module that writes the UNet's skip residuals as a ControlNet
does) and Restart sampling, on the JAX tests' reduced SD1.5
(`SD1UNet(base_channels=32)`) built in JAX from a seed and bridged into the
port with strict=True, at 32×32 latents; inject, eject and stacking at full
width on `SD1UNet(device="meta")`. The JAX models run eagerly (their
adapters live outside the pytree a `jax.jit` would flatten). Float32 on
both sides: 1e-4 relative; the SAG mask exactly; ejecting restores the
bare output bit for bit.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import ReferenceOnlyControlAdapter as JaxRefOnly
from refiners_tpu.foundationals.latent_diffusion import SD1IPAdapter as JaxSD1IPAdapter
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1_Inpainting as JaxInpainting
from refiners_tpu.foundationals.latent_diffusion import StyleAlignedAdapter as JaxStyleAlignedAdapter
from refiners_tpu.foundationals.latent_diffusion import style_aligned as jax_style_aligned
from refiners_tpu.foundationals.latent_diffusion.restart import Restart as JaxRestart
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    ReferenceOnlyControlAdapter,
    Restart,
    SD1Autoencoder,
    SD1IPAdapter,
    SD1UNet,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
    StyleAlignedAdapter,
)
from refiners_tpu_torch.foundationals.latent_diffusion import style_aligned
from refiners_tpu_torch.foundationals.latent_diffusion.reference_only_control import (
    SelfAttentionInjectionAdapter,
    SelfAttentionInjectionPassthrough,
)
from refiners_tpu_torch.foundationals.latent_diffusion.self_attention_guidance import SelfAttentionMap, SelfAttentionShape
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import SD1SAGAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.style_aligned import SharedSelfAttentionAdapter

TOL = 1e-4
LATENT = 32  # the middle block at 4×4: 16 tokens in SAG's mask
STEPS = 10
STEP = 3
MASS_MARGIN = 1e-3  # every token's attention mass this far from SAG's threshold, so the mask is exact


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


def _stub() -> Any:
    return fl.Chain(fl.Identity())


def _build(in_channels: int, seed: int) -> tuple[Any, StableDiffusion_1]:
    """The reduced SD1.5 (text encoder stubbed: embeddings are given) in both packages, DDIM 10 steps."""
    jax_manual_seed(seed)
    jax_cls, cls = (JaxStableDiffusion_1, StableDiffusion_1) if in_channels == 4 else (JaxInpainting, StableDiffusion_1_Inpainting)
    jax_sd = jax_cls(unet=JaxSD1UNet(in_channels=in_channels, base_channels=32), lda=JaxSD1Autoencoder(),
                     clip_text_encoder=jfl.Chain(jfl.Identity()), solver=JaxDDIM(num_inference_steps=STEPS))  # fmt: skip
    sd = cls(unet=SD1UNet(in_channels=in_channels, base_channels=32), lda=SD1Autoencoder(), clip_text_encoder=_stub(),
             solver=DDIM(num_inference_steps=STEPS), device="cpu")  # fmt: skip
    _bridge(sd.unet, jax_sd.unet)
    return jax_sd, sd


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_1]:
    return _build(4, seed=0)


@pytest.fixture(scope="module")
def inpainting() -> tuple[Any, StableDiffusion_1_Inpainting]:
    """The 9-channel model with its mask and masked-image latents set directly (no VAE encode)."""
    jax_sd, sd = _build(9, seed=1)
    rs = np.random.RandomState(10)
    mask = (rs.rand(1, LATENT, LATENT, 1) > 0.5).astype(np.float32)
    target = rs.randn(1, LATENT, LATENT, 4).astype(np.float32)
    jax_sd.mask_latents, jax_sd.target_image_latents = jnp.asarray(mask), jnp.asarray(target)
    sd.mask_latents, sd.target_image_latents = torch.tensor(nhwc_to_nchw(mask)), torch.tensor(nhwc_to_nchw(target))
    return jax_sd, sd


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(11)
    return {"x": rs.randn(1, LATENT, LATENT, 4).astype(np.float32), "emb": rs.randn(2, 77, 768).astype(np.float32),
            "guide": rs.randn(1, LATENT, LATENT, 4).astype(np.float32), "noise": rs.randn(2, LATENT, LATENT, 4).astype(np.float32),
            "image_tokens": rs.randn(1, 4, 768).astype(np.float32)}  # fmt: skip


def _predict(jax_sd: Any, sd: StableDiffusion_1, x: np.ndarray, emb: np.ndarray, step: int = STEP) -> tuple[np.ndarray, np.ndarray]:
    """`predict_noise` (CFG 7.5) in both packages, NHWC."""
    want = np.asarray(jax_sd.predict_noise(jnp.asarray(x), step, clip_text_embedding=jnp.asarray(emb), condition_scale=7.5))
    with torch.inference_mode():
        got = sd.predict_noise(torch.tensor(nhwc_to_nchw(x)), step, clip_text_embedding=torch.tensor(emb), condition_scale=7.5)
    return nchw_to_nhwc(got.numpy()), want


def _step(jax_sd: Any, sd: StableDiffusion_1, x: np.ndarray, emb: np.ndarray, step: int = STEP) -> tuple[np.ndarray, np.ndarray]:
    """One denoising step (CFG 7.5, DDIM) in both packages, NHWC."""
    want = np.asarray(jax_sd(jnp.asarray(x), step, clip_text_embedding=jnp.asarray(emb), condition_scale=7.5))
    with torch.inference_mode():
        got = sd(torch.tensor(nhwc_to_nchw(x)), step, clip_text_embedding=torch.tensor(emb), condition_scale=7.5)
    return nchw_to_nhwc(got.numpy()), want


# -- self-attention guidance -----------------------------------------------------

_JAX_SAG: dict[int, Any] = {}


def _jax_sag(jax_sd: Any, enable: bool) -> None:
    """JAX's SAG at 0.75 on `jax_sd`, one adapter per model, injected or
    ejected. The JAX package's `set_self_attention_guidance(True)` after a
    `False` builds a second adapter, which reads a context its recorders no
    longer write (ROADMAP Queue 3; the port's facade is held to it in
    `test_sag_can_be_enabled_again`); re-injecting the first adapter avoids it."""
    from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1SAGAdapter as JaxSD1SAGAdapter

    sag = _JAX_SAG.setdefault(id(jax_sd), JaxSD1SAGAdapter(jax_sd.unet, scale=0.75))
    if enable:
        sag.inject()
    else:
        sag.eject()


def test_sag_attention_map_and_mask_match_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """The middle block's attention map after one CFG UNet call (float32),
    and SAG's mask from it, exactly: every token's mass, averaged over heads
    and summed over queries, lies at least `MASS_MARGIN` from the threshold 1."""
    jax_sd, sd = models
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=0.75)
    jax_sag, sag = jax_sd._find_sag_adapter(), sd._find_sag_adapter()
    assert jax_sag is not None and sag is not None
    x, emb = inputs["x"], inputs["emb"]
    jax_sd.set_unet_context(timestep=jax_sd.solver.timesteps[STEP][None], clip_text_embedding=jnp.asarray(emb))
    jax_sd.unet(jnp.asarray(np.concatenate([x, x])))
    with torch.inference_mode():
        sd.set_unet_context(timestep=sd.solver.timesteps[STEP][None], clip_text_embedding=torch.tensor(emb))
        sd.unet(torch.tensor(nhwc_to_nchw(np.concatenate([x, x]))))
    want_map = np.asarray(jax_sag.use_context("self_attention_map")["middle_block_attn_map"])
    got_map = sd.unet.use_context("self_attention_map")["middle_block_attn_map"].numpy()
    assert got_map.shape == want_map.shape == (2, 8, 16, 16) and _rel(got_map, want_map) <= TOL
    mass = want_map[:1].mean(axis=1).sum(axis=1)
    assert np.abs(mass - 1.0).min() >= MASS_MARGIN and 0 < (mass > 1.0).sum() < mass.size
    assert sd.unet.use_context("self_attention_map")["middle_block_attn_shape"] == [(4, 4)]
    want_mask = np.asarray(jax_sag.compute_sag_mask(jnp.asarray(x)))
    got_mask = sag.compute_sag_mask(torch.tensor(nhwc_to_nchw(x)))
    assert got_mask.shape == (1, 4, LATENT, LATENT)
    np.testing.assert_array_equal(nchw_to_nhwc(got_mask.numpy()), want_mask)
    assert sd.unet.use_context("self_attention_map")["middle_block_attn_shape"] == []  # popped
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)


def test_sag_step_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """`predict_noise` with SAG at 0.75: the CFG call, the degraded latents and the second UNet call."""
    jax_sd, sd = models
    bare, _ = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=0.75)
    got, want = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_predict(jax_sd, sd, inputs["x"], inputs["emb"])[0], bare)


def test_sag_with_ip_adapter_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """SAG beside an IP-Adapter (a stand-in encoder, the image tokens given):
    the degraded call takes the negative half of the image tokens too."""
    jax_sd, sd = models
    encoders = []
    for ns in (jfl, fl):
        enc = ns.Chain()
        enc.embedding_dim, enc.output_dim = 1280, 1024  # type: ignore[attr-defined]
        encoders.append(enc)
    jax_manual_seed(12)
    jax_ip = JaxSD1IPAdapter(jax_sd.unet, clip_image_encoder=encoders[0]).inject()
    ip = SD1IPAdapter(sd.unet, clip_image_encoder=encoders[1]).inject()
    _bridge(sd.unet, jax_sd.unet)  # the image keys' and values' projections
    tokens = np.concatenate([np.zeros_like(inputs["image_tokens"]), inputs["image_tokens"]])
    jax_ip.set_clip_image_embedding(jnp.asarray(tokens))
    ip.set_clip_image_embedding(torch.tensor(tokens))
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=0.75)
    got, want = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    assert ip.use_context("ip_adapter")["clip_image_embedding"].shape == (2, 4, 768)  # restored after the split
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)
    jax_ip.eject()
    ip.eject()
    assert _rel(got, want) <= TOL


def test_sag_inpainting_matches_jax(inpainting: tuple[Any, StableDiffusion_1_Inpainting], inputs: dict[str, np.ndarray]) -> None:
    """The inpainting facade's SAG: the mask and masked-image latents joined to the degraded latents."""
    jax_sd, sd = inpainting
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=0.75)
    assert sd.has_self_attention_guidance() and isinstance(sd._find_sag_adapter(), SD1SAGAdapter)
    got, want = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)
    assert not sd.has_self_attention_guidance() and _rel(got, want) <= TOL


def test_sag_can_be_enabled_again(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """The facade's SAG disabled and enabled again (a new adapter around the
    same UNet) gives the same step as the first time, bit for bit."""
    _, sd = models
    x, emb = torch.tensor(nhwc_to_nchw(inputs["x"])), torch.tensor(inputs["emb"])
    steps = []
    for _ in range(2):
        sd.set_self_attention_guidance(True, scale=0.75)
        with torch.inference_mode():
            steps.append(sd.predict_noise(x, STEP, clip_text_embedding=emb, condition_scale=7.5))
        sd.set_self_attention_guidance(False)
    assert torch.equal(steps[0], steps[1])


def test_set_self_attention_guidance_on_facades() -> None:
    """Enabling injects one adapter (a second call only sets its scale);
    disabling ejects it, on both facades built on the CPU."""
    for cls, channels in ((StableDiffusion_1, 4), (StableDiffusion_1_Inpainting, 9)):
        sd = cls(unet=SD1UNet(in_channels=channels, base_channels=32), lda=SD1Autoencoder(), clip_text_encoder=_stub(),
                 device="cpu")  # fmt: skip
        assert not sd.has_self_attention_guidance()
        sd.set_self_attention_guidance(True, scale=0.5)
        sd.set_self_attention_guidance(True, scale=0.75)
        assert sd.has_self_attention_guidance() and sd._find_sag_adapter().scale == 0.75
        assert len(list(sd.unet.layers(SelfAttentionMap, recurse=True))) == 1
        assert len(list(sd.unet.layers(SelfAttentionShape, recurse=True))) == 1
        sd.set_self_attention_guidance(False)
        assert not sd.has_self_attention_guidance() and sd.unet.parent is None
        assert not list(sd.unet.layers(SelfAttentionMap, recurse=True))


# -- StyleAligned ---------------------------------------------------------------


@pytest.mark.parametrize("module", ["ExtractReferenceFeatures", "AdaIN", "ScaleReferenceFeatures", "query", "key", "value"])
def test_style_aligned_modules_match_jax(module: str) -> None:
    """Each piece on a seeded (4, 64, 32) CFG batch of 2 samples; the Q, K
    and V pipelines (AdaIN without concatenation, both, concatenation only) at scale 0.8."""
    rs = np.random.RandomState(13)
    x, ref = rs.randn(4, 64, 32).astype(np.float32), rs.randn(4, 64, 32).astype(np.float32)
    flags = {"query": (True, False), "key": (True, True), "value": (False, True)}
    if module in flags:
        adain, concatenate = flags[module]
        jax_m = jax_style_aligned.StyleAligned(adain=adain, concatenate=concatenate, scale=0.8)
        m = style_aligned.StyleAligned(adain=adain, concatenate=concatenate, scale=0.8)
        args: tuple[np.ndarray, ...] = (x,)
    else:
        kwargs = {"scale": 0.8} if module == "ScaleReferenceFeatures" else {}
        jax_m, m = getattr(jax_style_aligned, module)(**kwargs), getattr(style_aligned, module)(**kwargs)
        args = (x, ref) if module == "AdaIN" else (x,)
    want = jax_m(*(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = m(*(torch.tensor(a) for a in args))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), np.asarray(w)) <= TOL
    if module in ("key", "value"):
        assert got[0].shape == (4, 128, 32)


def test_style_aligned_unet_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """A CFG UNet call at batch 2 (CFG batch 4) with StyleAligned at 0.8;
    the reference sample is changed only by its own statistics; eject
    restores the bare call bit for bit."""
    jax_sd, sd = models
    rs = np.random.RandomState(14)
    x = rs.randn(2, LATENT, LATENT, 4).astype(np.float32)
    emb = rs.randn(4, 77, 768).astype(np.float32)
    bare, _ = _predict(jax_sd, sd, x, emb)
    jax_adapter = JaxStyleAlignedAdapter(jax_sd.unet, scale=0.8).inject()
    adapter = StyleAlignedAdapter(sd.unet, scale=0.8).inject()
    assert len(adapter.shared_self_attention_adapters) == 16 and adapter.scale == 0.8
    got, want = _predict(jax_sd, sd, x, emb)
    adapter.scale = 0.5
    assert {m.scale for m in sd.unet.layers(style_aligned.ScaleReferenceFeatures, recurse=True)} == {0.5}
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    assert not list(sd.unet.layers(style_aligned.StyleAligned, recurse=True))
    np.testing.assert_array_equal(_predict(jax_sd, sd, x, emb)[0], bare)


# -- reference-only control -----------------------------------------------------


def _guide(jax_sd: Any, sd: StableDiffusion_1, inputs: dict[str, np.ndarray], nine: bool) -> tuple[Any, torch.Tensor]:
    """The CFG-stacked guide latents noised to `STEP` (by the JAX solver, as
    `golden_cfg.run_refonly` does); with `nine`, sd-webui's inpainting layout."""
    guide = np.concatenate([inputs["guide"], inputs["guide"]])
    noised = np.asarray(jax_sd.solver.add_noise(jnp.asarray(guide), jnp.asarray(inputs["noise"]), STEP))
    if nine:
        noised = np.concatenate([noised, np.zeros_like(noised[..., :1]), guide], axis=-1)
    return jnp.asarray(noised), torch.tensor(nhwc_to_nchw(noised))


@pytest.mark.parametrize("nine", [False, True], ids=["4-channel", "9-channel"])
def test_reference_only_step_matches_jax(
    nine: bool, models: tuple[Any, StableDiffusion_1], inpainting: tuple[Any, StableDiffusion_1_Inpainting],
    inputs: dict[str, np.ndarray],
) -> None:  # fmt: skip
    """One DDIM step with reference-only control (style_cfg 0.5): the guide
    pass, then guided (keys twice as long) and unguided self-attention."""
    jax_sd, sd = inpainting if nine else models
    bare, _ = _step(jax_sd, sd, inputs["x"], inputs["emb"])
    jax_adapter = JaxRefOnly(jax_sd.unet).inject()
    adapter = ReferenceOnlyControlAdapter(sd.unet).inject()
    jax_guide, guide = _guide(jax_sd, sd, inputs, nine)
    jax_adapter.set_controlnet_condition(jax_guide)
    adapter.set_controlnet_condition(guide)
    assert isinstance(sd.unet[0], SelfAttentionInjectionPassthrough) and len(adapter.sub_adapters) == 16
    got, want = _step(jax_sd, sd, inputs["x"], inputs["emb"])
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_step(jax_sd, sd, inputs["x"], inputs["emb"])[0], bare)


def _residual_writer(ns: Any, add: Any) -> Any:
    """A stand-in for a ControlNet: first in the UNet, it adds 0.05·(n + 1)
    to each of the 13 skip residuals through the "unet" context."""

    def write(residuals: list[Any], x: Any) -> None:
        for n in range(13):
            residuals[n] = add(residuals[n], 0.05 * (n + 1))

    return ns.Passthrough(ns.SetContext(context="unet", key="residuals", callback=write))


def test_reference_only_keeps_controlnet_residuals(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """Reference-only injected first, then a residual writer put first in the
    UNet (as `SD1ControlnetAdapter` puts its ControlNet): the guide pass keeps
    the main pass's residuals aside and restores them."""
    jax_sd, sd = models
    jax_adapter = JaxRefOnly(jax_sd.unet).inject()
    adapter = ReferenceOnlyControlAdapter(sd.unet).inject()
    jax_guide, guide = _guide(jax_sd, sd, inputs, nine=False)
    jax_adapter.set_controlnet_condition(jax_guide)
    adapter.set_controlnet_condition(guide)
    without, _ = _step(jax_sd, sd, inputs["x"], inputs["emb"])
    jax_writer, writer = _residual_writer(jfl, lambda r, v: r + v), _residual_writer(fl, lambda r, v: r + v)
    jax_sd.unet.insert(0, jax_writer)
    sd.unet.insert(0, writer)
    got, want = _step(jax_sd, sd, inputs["x"], inputs["emb"])
    jax_sd.unet.remove(jax_writer)
    sd.unet.remove(writer)
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, without) > 1e-3


# -- Restart --------------------------------------------------------------------


def test_restart_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """Restart(num_steps=4, num_iterations=2) on DDIM 10 steps: its
    timesteps, start step and end timestep, and one call with the JAX key's
    noise injected through `_restart_noise`."""
    jax_sd, sd = models
    jax_restart, restart = JaxRestart(ldm=jax_sd, num_steps=4, num_iterations=2), Restart(ldm=sd, num_steps=4, num_iterations=2)
    np.testing.assert_array_equal(restart.timesteps.numpy(), np.asarray(jax_restart.timesteps))
    assert (restart.start_step, restart.end_timestep) == (jax_restart.start_step, jax_restart.end_timestep)
    assert restart.timesteps[0] == restart.end_timestep and restart.timesteps[-1] == int(sd.solver.timesteps[restart.start_step])
    key = jax.random.key(15)
    x, emb = inputs["x"], inputs["emb"]
    want = np.asarray(jax_restart(jnp.asarray(x), clip_text_embedding=jnp.asarray(emb), condition_scale=7.5, key=key))
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(key, i), x.shape, dtype=jnp.float32)) for i in range(2)]
    drawn: list[int] = []

    def jax_noise(generator: Any, shape: tuple[int, ...], device: Any, iteration: int) -> torch.Tensor:
        drawn.append(iteration)
        return torch.tensor(nhwc_to_nchw(noises[iteration]))

    restart._restart_noise = jax_noise  # type: ignore[method-assign]
    solver = sd.solver
    with torch.inference_mode():
        got = restart(torch.tensor(nhwc_to_nchw(x)), clip_text_embedding=torch.tensor(emb), condition_scale=7.5)
    assert drawn == [0, 1] and sd.solver is solver
    assert _rel(nchw_to_nhwc(got.numpy()), want) <= TOL
    with pytest.raises(AssertionError, match="only works with DDIM"):
        Restart(ldm=StableDiffusion_1(unet=sd.unet, lda=sd.lda, clip_text_encoder=_stub(), device="cpu"))


# -- inject, eject and stacking at full width, on the meta device ----------------


def test_inject_eject_and_stacking_on_meta() -> None:
    """Reference-only first (its guide UNet is a structural copy, which no
    adapter inside the UNet allows), then an IP-Adapter (its ViT-H built on
    the UNet's device) and SAG around them; StyleAligned with SAG; each
    ejected out of the order of injection, leaving the bare UNet's keys."""
    unet = SD1UNet(in_channels=4, device="meta")
    keys = list(unet.state_dict())
    types = [type(m).__name__ for m in unet]
    parameters = {id(p) for p in unet.parameters()}
    refonly = ReferenceOnlyControlAdapter(unet).inject()
    guide = unet[0].layer("SD1UNet", SD1UNet)
    assert {id(p) for p in guide.parameters()} == parameters  # the guide UNet adds no weights
    assert len(list(unet.layers(SelfAttentionInjectionAdapter, recurse=True))) == 16
    with pytest.raises(RuntimeError, match="eject it first"):
        refonly.structural_copy()
    ip = SD1IPAdapter(unet).inject()
    assert ip.clip_image_encoder.device == torch.device("meta") and ip.image_proj.device == torch.device("meta")
    # the guide UNet's 16 text cross-attentions take the image tokens too, as in the JAX package
    assert len(ip.sub_adapters) == 32 and list(ip.state_dict()) == [f"SD1UNet.{k}" for k in unet.state_dict()]
    sag = SD1SAGAdapter(unet, scale=0.75).inject()
    assert unet.parent is sag and len(list(unet.layers(SelfAttentionMap, recurse=True))) == 1
    for adapter in (ip, sag, refonly):  # SAG's recorders sit in the first MiddleBlock: the guide UNet's
        adapter.eject()
    assert list(unet.state_dict()) == keys and [type(m).__name__ for m in unet] == types

    shared = StyleAlignedAdapter(unet, scale=0.8).inject()
    sag = SD1SAGAdapter(unet).inject()
    assert len(list(unet.layers(SharedSelfAttentionAdapter, recurse=True))) == 16
    assert len(unet.state_dict()) == len(keys)  # StyleAligned holds no weights
    shared.eject()
    sag.eject()
    assert list(unet.state_dict()) == keys and unet.parent is None
    assert not list(unet.layers(SharedSelfAttentionAdapter, recurse=True))
    assert not list(unet.layers(SelfAttentionMap, recurse=True))
