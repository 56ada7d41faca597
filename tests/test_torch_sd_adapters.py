"""The port's SD1.5 spatial-control adapters against the JAX package, on the CPU.

ControlNet (single and stacked), T2I-Adapter and FreeU: inject, eject and
stacking on a full-width `SD1UNet(device="meta")`, which holds no memory;
their modules against JAX on seeded numpy inputs and bridged weights, at
the JAX tests' reduced UNet width (`SD1UNet(base_channels=32)`) where the
adapter allows it and at full width on 8×8 latents where it does not (the
ControlNet is a full-width copy of the UNet's encoder whatever the UNet's
width); and 3 denoising steps of the reduced SD1.5 with a LoRA and FreeU.
Float32 on both sides: 1e-4 relative; ejecting restores the base output
bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.latent_diffusion import DPMSolver as JaxDPMSolver
from refiners_tpu.foundationals.latent_diffusion import SD1T2IAdapter as JaxSD1T2IAdapter
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import SDFreeUAdapter as JaxSDFreeUAdapter
from refiners_tpu.foundationals.latent_diffusion import SDLoraManager as JaxSDLoraManager
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion.freeu import fourier_filter as jax_fourier_filter
from refiners_tpu.foundationals.latent_diffusion.range_adapter import RangeAdapter2d as JaxRangeAdapter2d
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.controlnet import (
    ConditionEncoder as JaxCNConditionEncoder,
)
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.controlnet import Controlnet as JaxControlnet
from refiners_tpu.foundationals.latent_diffusion.t2i_adapter import ConditionEncoder as JaxT2IConditionEncoder
from refiners_tpu.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL as JaxConditionEncoderXL
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    Controlnet,
    DPMSolver,
    SD1Autoencoder,
    SD1ControlnetAdapter,
    SD1T2IAdapter,
    SD1UNet,
    SDFreeUAdapter,
    SDLoraManager,
    StableDiffusion_1,
    T2IFeatures,
)
from refiners_tpu_torch.foundationals.latent_diffusion.freeu import FreeUResidualConcatenator, fourier_filter
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeAdapter2d
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import ConditionEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoder as T2IConditionEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualConcatenator

TOL = 1e-4
# the chained slice (3 UNet steps): deep UNets amplify float noise at every
# cross-attention block (as in tests/test_torch_sd1.py)
SLICE_TOL = 1e-4
REDUCED = (32, 64, 128, 128)  # the reduced UNet's widths at down blocks 2, 5, 8 and 11
CONTROLNET_PARAMETERS = 361_279_120


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridge(jax_module: Any, port_module: torch.nn.Module) -> None:
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()})


def _types(chain: fl.Chain) -> list[str]:
    return [type(m).__name__ for m in chain]


# -- inject, eject and stacking at full width, on the meta device -------------


def test_inject_eject_and_stacking_on_meta() -> None:
    unet = SD1UNet(in_channels=4, device="meta")
    keys = list(unet.state_dict())
    depth = SD1ControlnetAdapter(unet, name="depth", scale=0.3).inject()
    canny = SD1ControlnetAdapter(unet, name="canny", scale=0.7, scale_decay=0.825).inject()
    assert list(unet._modules)[:3] == ["Controlnet_1", "Controlnet_2", "TimestepEncoder"]
    assert unet[0] is canny.controlnet and unet[1] is depth.controlnet
    assert canny.controlnet.device == torch.device("meta") and canny.controlnet.dtype == torch.float32
    assert sum(p.numel() for p in canny.controlnet.parameters()) == CONTROLNET_PARAMETERS
    assert len(unet.state_dict()) == len(keys) + 2 * len(depth.controlnet.state_dict())
    assert {r.context_key for r in canny.controlnet.layers(RangeAdapter2d, recurse=True)} == {"timestep_embedding_canny"}
    assert (canny.scale, canny.scale_decay, depth.scale) == (0.7, 0.825, 0.3)
    with pytest.raises(AssertionError, match="canny is already injected"):
        SD1ControlnetAdapter(unet, name="canny").inject()
    with pytest.raises(RuntimeError, match="eject it first"):
        canny.structural_copy()

    pose = SD1T2IAdapter(unet, name="pose", scale=0.8).inject()
    for n in (2, 5, 8, 11):
        block = unet.layer(("DownBlocks", n), fl.Chain)
        assert _types(block)[-2:] == ["T2IFeatures", "ResidualAccumulator"]
    assert pose.condition_encoder.device == torch.device("meta")
    pose.scale = 0.5
    assert {f.scale for f in unet.layers(T2IFeatures, recurse=True)} == {0.5}
    with pytest.raises(AssertionError, match="pose is already injected"):
        SD1T2IAdapter(unet, name="pose").inject()

    freeu = SDFreeUAdapter(unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    assert [type(b[0]).__name__ for b in unet.UpBlocks][:3] == [
        "FreeUResidualConcatenator", "FreeUResidualConcatenator", "ResidualConcatenator"
    ]  # fmt: skip
    # eject out of the order of injection: the inner ControlNet first
    for adapter in (depth, pose, freeu, canny):
        adapter.eject()
    assert list(unet.state_dict()) == keys
    assert _types(unet) == ["TimestepEncoder", "DownBlocks", "Sum", "UpBlocks", "Chain"]
    assert not list(unet.layers(T2IFeatures, recurse=True)) and not list(unet.layers(FreeUResidualConcatenator, recurse=True))
    assert [type(b[0]) for b in unet.UpBlocks] == [ResidualConcatenator] * 12
    assert unet.parent is None


def test_range_adapter_context_key_matches_jax() -> None:
    adapters = [cls(target=ns.Conv2d(4, 8, 3, padding=1), channels=8, embedding_dim=16, context_key="timestep_embedding")
                for cls, ns in ((JaxRangeAdapter2d, jfl), (RangeAdapter2d, fl))]  # fmt: skip
    for adapter in adapters:
        assert adapter.context_key == "timestep_embedding"
        adapter.context_key = "timestep_embedding_canny"
        assert adapter.context_key == "timestep_embedding_canny"
    assert adapters[1].ensure_find(fl.UseContext).key == "timestep_embedding_canny"


# -- ControlNet -----------------------------------------------------------------


def test_controlnet_condition_encoder_matches_jax() -> None:
    jax_manual_seed(1)
    jax_encoder, encoder = JaxCNConditionEncoder(), ConditionEncoder()
    _bridge(jax_encoder, encoder)
    x = np.random.RandomState(2).rand(2, 64, 48, 3).astype(np.float32)
    with torch.no_grad():
        got = nchw_to_nhwc(encoder(torch.tensor(nhwc_to_nchw(x))).numpy())
    want = np.asarray(jax_encoder(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 8, 6, 320) and _rel(got, want) <= TOL


def _controlnet_contexts(host: Any, wrap: Callable[[np.ndarray], Any], condition: Any, emb: np.ndarray) -> None:
    """The contexts a UNet gives its ControlNets, on a bare host chain."""
    host.set_context("unet", {"residuals": [0.0] * 13})
    host.set_context("diffusion", {"timestep": wrap(np.array([500]))})
    host.set_context("range_adapter", {})
    host.set_context("cross_attention_block", {"clip_text_embedding": wrap(emb)})
    host.set_context("controlnet", {"condition_canny": condition})
    host.set_context("sampling", {"shapes": []})


def test_controlnet_residuals_match_jax() -> None:
    """The 13 residuals a full-width Controlnet adds to the UNet's skips, at
    8×8 latents of an inpainting UNet's 9 channels (the first 4 taken), CFG
    batch 2 against a condition of batch 1, scale 0.7 and decay 0.825."""
    rs = np.random.RandomState(3)
    x, emb = rs.randn(2, 8, 8, 9).astype(np.float32), rs.randn(2, 77, 768).astype(np.float32)
    condition = rs.rand(1, 64, 64, 3).astype(np.float32)
    jax_manual_seed(2)
    jax_controlnet = JaxControlnet(name="canny", scale=0.7, scale_decay=0.825)
    host = jfl.Chain(jax_controlnet)
    _controlnet_contexts(host, jnp.asarray, jnp.asarray(condition), emb)
    host(jnp.asarray(x))
    want = [np.asarray(r) for r in host.provider.get_context("unet")["residuals"]]

    controlnet = Controlnet(name="canny", scale=0.7, scale_decay=0.825, device="meta").to_empty(device="cpu")
    load_jax_state_dict(controlnet, {k: np.asarray(v) for k, v in jax_controlnet.state_dict().items()})
    del host, jax_controlnet
    assert controlnet.scale_decays == pytest.approx([0.825 ** (12 - i) for i in range(13)])
    host = fl.Chain(controlnet)
    _controlnet_contexts(host, torch.tensor, torch.tensor(nhwc_to_nchw(condition)), emb)
    with torch.no_grad():
        out = host(torch.tensor(nhwc_to_nchw(x)))
    assert torch.equal(out, torch.tensor(nhwc_to_nchw(x)))  # a Passthrough: the latents go on unchanged
    got = host.provider.get_context("unet")["residuals"]
    assert len(got) == len(want) == 13
    for n, (g, w) in enumerate(zip(got, want)):
        g = nchw_to_nhwc(g.numpy())
        assert g.shape == w.shape and _rel(g, w) <= TOL, n
    assert got[0].shape == (2, 320, 8, 8) and got[12].shape == (2, 1280, 1, 1)


# -- T2I-Adapter ----------------------------------------------------------------


@pytest.mark.parametrize("xl", [False, True])
def test_t2i_condition_encoder_matches_jax(xl: bool) -> None:
    """The feature pyramid at reduced widths: 4 maps, each pushed by a
    StatefulResidualBlocks through the "t2iadapter" context."""
    jax_manual_seed(3)
    jax_cls, cls = (JaxConditionEncoderXL, ConditionEncoderXL) if xl else (JaxT2IConditionEncoder, T2IConditionEncoder)
    jax_encoder, encoder = jax_cls(channels=REDUCED), cls(channels=REDUCED)
    _bridge(jax_encoder, encoder)
    x = np.random.RandomState(4).rand(1, 128, 128, 3).astype(np.float32)
    with torch.no_grad():
        got = [nchw_to_nhwc(f.numpy()) for f in encoder(torch.tensor(nhwc_to_nchw(x)))]
    want = [np.asarray(f) for f in jax_encoder(jnp.asarray(x))]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(_rel(g, w) <= TOL for g, w in zip(got, want))
    # the context is reset after each call: a second call gives 4 maps again
    with torch.no_grad():
        assert len(encoder(torch.tensor(nhwc_to_nchw(x)))) == 4


@pytest.fixture(scope="module")
def unets() -> tuple[Any, SD1UNet]:
    jax_manual_seed(4)
    jax_unet, unet = JaxSD1UNet(in_channels=4, base_channels=32), SD1UNet(in_channels=4, base_channels=32)
    _bridge(jax_unet, unet)
    return jax_unet, unet


@pytest.fixture(scope="module")
def unet_inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(5)
    return {"x": rs.randn(2, 16, 16, 4).astype(np.float32), "emb": rs.randn(2, 77, 768).astype(np.float32),
            "condition": rs.rand(1, 128, 128, 3).astype(np.float32)}  # fmt: skip


def _jax_unet(unet: Any, inputs: dict[str, np.ndarray], contexts: dict[str, Any] | None = None) -> np.ndarray:
    """One JAX UNet call under jit (contexts set inside: those set outside do not reach it)."""

    def call(u: Any, x: jax.Array, e: jax.Array, c: dict[str, Any]) -> jax.Array:
        u.set_timestep(jnp.asarray([500]))
        u.set_clip_text_embedding(e)
        for name, value in c.items():
            u.set_context(name, value)
        return u(x)

    return np.asarray(jax.jit(call)(unet, jnp.asarray(inputs["x"]), jnp.asarray(inputs["emb"]), contexts or {}))


def _port_unet(unet: SD1UNet, inputs: dict[str, np.ndarray]) -> np.ndarray:
    with torch.no_grad():
        unet.set_timestep(torch.tensor([500]))
        unet.set_clip_text_embedding(torch.tensor(inputs["emb"]))
        return nchw_to_nhwc(unet(torch.tensor(nhwc_to_nchw(inputs["x"]))).numpy())


def test_sd1_t2i_adapter_matches_jax(unets: tuple[Any, SD1UNet], unet_inputs: dict[str, np.ndarray]) -> None:
    """SD1T2IAdapter at scale 0.8 on the reduced UNet, with an encoder of its widths."""
    jax_unet, unet = unets
    base = _port_unet(unet, unet_inputs)
    jax_manual_seed(5)
    jax_adapter = JaxSD1T2IAdapter(jax_unet, name="pose", scale=0.8,
                                   condition_encoder=JaxT2IConditionEncoder(channels=REDUCED)).inject()  # fmt: skip
    adapter = SD1T2IAdapter(unet, name="pose", scale=0.8, condition_encoder=T2IConditionEncoder(channels=REDUCED)).inject()
    _bridge(jax_adapter.condition_encoder, adapter.condition_encoder)
    jax_features = jax_adapter.compute_condition_features(jnp.asarray(unet_inputs["condition"]))
    with torch.no_grad():
        adapter.set_condition_features(adapter.compute_condition_features(torch.tensor(nhwc_to_nchw(unet_inputs["condition"]))))
    want = _jax_unet(jax_unet, unet_inputs, {"t2iadapter": {"condition_features_pose": jax_features}})
    got = _port_unet(unet, unet_inputs)
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, base) > 1e-3
    np.testing.assert_array_equal(_port_unet(unet, unet_inputs), base)


# -- FreeU ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape, scale, threshold", [((2, 8, 8, 4), 0.9, 1), ((1, 7, 5, 3), 0.2, 2), ((2, 16, 16, 8), 0.2, 1), ((1, 1, 1, 2), 0.5, 1)]
)
def test_fourier_filter_matches_jax(shape: tuple[int, ...], scale: float, threshold: int) -> None:
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want = np.asarray(jax_fourier_filter(jnp.asarray(x), scale=scale, threshold=threshold))
    got = nchw_to_nhwc(fourier_filter(torch.tensor(nhwc_to_nchw(x)), scale=scale, threshold=threshold).numpy())
    assert _rel(got, want) <= TOL
    assert fourier_filter(torch.randn(1, 2, 4, 4, dtype=torch.bfloat16), scale=scale).dtype == torch.bfloat16


def test_freeu_matches_jax(unets: tuple[Any, SD1UNet], unet_inputs: dict[str, np.ndarray]) -> None:
    jax_unet, unet = unets
    base = _port_unet(unet, unet_inputs)
    jax_adapter = JaxSDFreeUAdapter(jax_unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    adapter = SDFreeUAdapter(unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    want = _jax_unet(jax_unet, unet_inputs)
    got = _port_unet(unet, unet_inputs)
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, base) > 1e-3
    np.testing.assert_array_equal(_port_unet(unet, unet_inputs), base)


# -- the slice ------------------------------------------------------------------


def test_lora_and_freeu_denoise_matches_jax() -> None:
    """3 DPM++ steps of the reduced SD1.5 (CFG 7.5) with a LoRA on the UNet's
    and CLIP's attention and feed-forward Linears, at scale 0.8, and FreeU."""
    from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock

    jax_manual_seed(6)
    jax_sd = JaxStableDiffusion_1(
        unet=JaxSD1UNet(in_channels=4, base_channels=32),
        lda=JaxSD1Autoencoder(),
        clip_text_encoder=JaxCLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=JaxDPMSolver(num_inference_steps=3),
    )
    sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DPMSolver(num_inference_steps=3),
        device="cpu",
    )
    for name in ("unet", "clip_text_encoder"):
        _bridge(getattr(jax_sd, name), getattr(sd, name))
    rs = np.random.RandomState(7)
    linears = [l for b in sd.unet.layers(CrossAttentionBlock, recurse=True) for l in b.layers(fl.Linear, recurse=True)]
    linears += [("text", l) for l in sd.clip_text_encoder.layers(fl.Linear, recurse=True)]  # type: ignore[misc]
    weights: dict[str, np.ndarray] = {}
    for n, item in enumerate(linears):
        part, linear = item if isinstance(item, tuple) else ("unet", item)
        weights[f"lora_{part}_{n:04d}.lora_down.weight"] = (rs.randn(8, linear.in_features) * 0.05).astype(np.float32)
        weights[f"lora_{part}_{n:04d}.lora_up.weight"] = (rs.randn(linear.out_features, 8) * 0.05).astype(np.float32)
    JaxSDLoraManager(jax_sd).add_loras("style", {k: jnp.asarray(v) for k, v in weights.items()}, scale=0.8,
                                       unet_inclusions=["CrossAttentionBlock"])  # fmt: skip
    SDLoraManager(sd).add_loras("style", {k: torch.tensor(v) for k, v in weights.items()}, scale=0.8,
                                unet_inclusions=["CrossAttentionBlock"])  # fmt: skip
    JaxSDFreeUAdapter(jax_sd.unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    SDFreeUAdapter(sd.unet, backbone_scales=[1.2, 1.4], skip_scales=[0.9, 0.2]).inject()
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())

    x = rs.randn(1, 16, 16, 4).astype(np.float32)
    emb_want = jax_sd.compute_clip_text_embedding("a cute cat", negative_text="blurry")
    want = jax.jit(lambda m, v, e: m.diffuse(v, clip_text_embedding=e, condition_scale=7.5))(jax_sd, jnp.asarray(x), emb_want)
    with torch.inference_mode():
        emb = sd.compute_clip_text_embedding("a cute cat", negative_text="blurry")
        got = sd.diffuse(torch.tensor(nhwc_to_nchw(x)), clip_text_embedding=emb, condition_scale=7.5)
    assert _rel(emb.numpy(), np.asarray(emb_want)) <= TOL
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= SLICE_TOL


def test_text_to_image_serves_an_adapted_model() -> None:
    """`TextToImage` serves the model as it stands: a T2I-Adapter injected
    and its condition set before the call changes the image; ejected, the
    same seed gives the bare image again, bit for bit."""
    from refiners_tpu_torch.pipelines import TextToImage

    sd = StableDiffusion_1(
        unet=SD1UNet(in_channels=4, base_channels=32),
        lda=SD1Autoencoder(),
        clip_text_encoder=CLIPTextEncoder(embedding_dim=768, num_layers=2, num_attention_heads=12),
        solver=DPMSolver(num_inference_steps=2),
        device="cpu",
    )
    pipe = TextToImage(sd, size=(128, 128))
    bare = np.asarray(pipe("a cute cat", seed=3))
    adapter = SD1T2IAdapter(sd.unet, name="pose", scale=0.8, condition_encoder=T2IConditionEncoder(channels=REDUCED)).inject()
    with torch.inference_mode():
        adapter.set_condition_features(adapter.compute_condition_features(torch.rand(1, 3, 128, 128)))
    adapted = np.asarray(pipe("a cute cat", seed=3))
    adapter.eject()
    assert adapted.shape == bare.shape == (128, 128, 3) and np.abs(adapted.astype(int) - bare).max() > 0
    np.testing.assert_array_equal(np.asarray(pipe("a cute cat", seed=3)), bare)
