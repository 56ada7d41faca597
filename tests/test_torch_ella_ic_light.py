"""The port's ELLA, IC-Light, InformativeDrawings and safetensors loading
against the JAX package, on the CPU.

ELLA's pieces each on random weights (its zero-initialized AdaLayerNorm
Linears drawn too, so that the modulation runs), then `SD1ELLAAdapter` at
its full widths on the JAX tests' reduced SD1.5 (`SD1UNet(base_channels=32)`,
text encoder stubbed), its weights damped ×0.2 as `golden_cfg.build_ella`
damps them (undamped random ELLA is chaotic); inject and eject at full width
on `SD1UNet(device="meta")`. `ICLight` on the reduced UNet and the full SD1
VAE, one patch given to both packages in their layouts. Weights are built in
JAX from a seed and bridged with strict=True. Float32: 1e-4 relative; an
adapted step differs from the bare one by more than 1e-3; ejecting restores
the bare step bit for bit; the gray composite exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

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
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_1 as JaxStableDiffusion_1
from refiners_tpu.foundationals.latent_diffusion import ella_adapter as jax_ella
from refiners_tpu.foundationals.latent_diffusion.preprocessors import InformativeDrawings as JaxInformativeDrawings
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1Autoencoder as JaxSD1Autoencoder
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1 import SD1ELLAAdapter as JaxSD1ELLAAdapter
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_1.ic_light import ICLight as JaxICLight
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.conversion.jax_bridge import _weight_layouts
from refiners_tpu_torch.fluxion.utils import save_to_safetensors
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    ELLA,
    ELLAAdapter,
    SD1Autoencoder,
    SD1ELLAAdapter,
    SD1UNet,
    StableDiffusion_1,
)
from refiners_tpu_torch.foundationals.latent_diffusion import ella_adapter
from refiners_tpu_torch.foundationals.latent_diffusion.preprocessors import InformativeDrawings
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import ICLight
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import DownBlocks

TOL = 1e-4
LATENT = 16
STEPS = 10
STEP = 3
DAMP = 0.2  # golden_cfg.build_ella: undamped random ELLA latents saturate the softmax
WIDTH, TIME_DIM, HEADS = 64, 32, 4  # the pieces' reduced widths
CONV_IN = "DownBlocks.Chain_1.Conv2d.weight"


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


def _to_jax_layout(port: torch.nn.Module, state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A port-layout state dict in the JAX package's layout (the bridge's permutations, inverted)."""
    layouts = _weight_layouts(port)
    return {k: v.transpose(np.argsort(layouts[k])) if k in layouts else v for k, v in state.items()}


def _randomize(jax_module: Any, port: torch.nn.Module, seed: int) -> None:
    """The same random weights in both packages: fan-in-scaled normals in the
    port's layout (so every zero-initialized Linear is drawn too), each
    package loading its own layout."""
    rs = np.random.RandomState(seed)
    state = {}
    for key, value in port.state_dict().items():
        fan_in = int(np.prod(value.shape[1:])) if value.ndim >= 2 else 1
        state[key] = (rs.randn(*value.shape) * (fan_in**-0.5 if value.ndim >= 2 else 0.1)).astype(np.float32)
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    jax_module.load_state_dict({k: jnp.asarray(v) for k, v in _to_jax_layout(port, state).items()})


def _run(jax_module: Any, port: torch.nn.Module, contexts: dict[str, dict[str, np.ndarray]], *inputs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:  # fmt: skip
    """`module(*inputs)` in both packages, each wrapped in a Chain that holds `contexts`."""
    jax_chain, chain = jfl.Chain(jax_module), fl.Chain(port)
    for name, values in contexts.items():
        jax_chain.set_context(name, {k: jnp.asarray(v) for k, v in values.items()})
        chain.set_context(name, {k: torch.tensor(v) for k, v in values.items()})
    want = np.asarray(jax_chain(*(jnp.asarray(x) for x in inputs)))
    with torch.no_grad():
        got = chain(*(torch.tensor(x) for x in inputs)).numpy()
    return got, want


# -- ELLA's pieces ----------------------------------------------------------------


def _pieces() -> dict[str, Callable[[Any], Any]]:
    """Each piece at the reduced widths, built from either package's module."""
    return {
        "LayerNormNoAffine": lambda m: m.LayerNormNoAffine(WIDTH, eps=1e-6),
        "SquaredReLU": lambda m: m.SquaredReLU(),
        "AdaLayerNorm": lambda m: m.AdaLayerNorm(WIDTH, TIME_DIM),
        "FeedForward": lambda m: m.FeedForward(WIDTH),
        "PerceiverAttention": lambda m: m.PerceiverAttention(WIDTH, HEADS, TIME_DIM),
        "Latents": lambda m: m.Latents(8, WIDTH),
        "OutputProjection": lambda m: m.OutputProjection(WIDTH, 48),
        "PerceiverResampler": lambda m: m.PerceiverResampler(TIME_DIM, WIDTH, 2, HEADS, 8, 48, 96),
    }


@pytest.mark.parametrize("name", list(_pieces()))
def test_ella_piece_matches_jax(name: str) -> None:
    """Each ELLA piece on random weights, the timestep embedding in its context."""
    jax_manual_seed(1)
    build = _pieces()[name]
    jax_piece, piece = build(jax_ella), build(ella_adapter)
    if list(piece.state_dict()):
        _randomize(jax_piece, piece, seed=2)
    rs = np.random.RandomState(3)
    contexts = {"ella": {"timestep_embedding": rs.randn(2, 1, TIME_DIM).astype(np.float32)}}
    x = rs.randn(2, 12, 96 if name == "PerceiverResampler" else WIDTH).astype(np.float32)
    inputs: tuple[np.ndarray, ...] = (x,)
    if name == "PerceiverAttention":  # (text, latents)
        inputs = (x, rs.randn(2, 8, WIDTH).astype(np.float32))
    got, want = _run(jax_piece, piece, contexts, *inputs)
    assert got.shape == want.shape and _rel(got, want) <= TOL


def test_ada_layer_norm_linear_starts_at_zero() -> None:
    """The modulation's Linear is zero at init: the piece is then a plain LayerNorm."""
    norm = ella_adapter.AdaLayerNorm(WIDTH, TIME_DIM)
    linear = norm.ensure_find(fl.Linear)
    assert not linear.weight.any() and not linear.bias.any()
    rs = np.random.RandomState(4)
    x = torch.tensor(rs.randn(2, 5, WIDTH).astype(np.float32))
    chain = fl.Chain(norm)
    chain.set_context("ella", {"timestep_embedding": torch.tensor(rs.randn(2, 1, TIME_DIM).astype(np.float32))})
    with torch.no_grad():
        np.testing.assert_array_equal(chain(x).numpy(), ella_adapter.LayerNormNoAffine(WIDTH, eps=1e-6)(x).numpy())


def test_ella_encoder_matches_jax() -> None:
    """`ELLA` (timestep encoder, resampler) on random weights, reading the
    diffusion timestep and the LLM embedding from its contexts."""
    jax_manual_seed(5)
    kwargs = dict(time_channel=32, timestep_embedding_dim=TIME_DIM, width=WIDTH, num_layers=2, num_heads=HEADS,
                  num_latents=8, input_dim=96, out_dim=48)  # fmt: skip
    jax_encoder, encoder = jax_ella.ELLA(**kwargs), ELLA(**kwargs)
    _randomize(jax_encoder, encoder, seed=6)
    rs = np.random.RandomState(7)
    contexts = {"diffusion": {"timestep": np.array([601.0], dtype=np.float32)},
                "adapted_cross_attention_block": {"llm_text_embedding": rs.randn(2, 12, 96).astype(np.float32)},
                "ella": {"timestep_embedding": None, "latents": None}}  # fmt: skip
    jax_chain, chain = jfl.Chain(jax_encoder), fl.Chain(encoder)
    for name, values in contexts.items():
        jax_chain.set_context(name, {k: None if v is None else jnp.asarray(v) for k, v in values.items()})
        chain.set_context(name, {k: None if v is None else torch.tensor(v) for k, v in values.items()})
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    jax_chain(jnp.asarray(nchw_to_nhwc(x)))
    with torch.no_grad():
        chain(torch.tensor(x))
    want = np.asarray(jax_chain.use_context("ella")["latents"])
    got = chain.use_context("ella")["latents"].numpy()
    assert got.shape == want.shape == (2, 8, 48) and _rel(got, want) <= TOL


# -- SD1ELLAAdapter on the reduced SD1.5 ----------------------------------------------


def _stub() -> Any:
    return fl.Chain(fl.Identity())


@pytest.fixture(scope="module")
def models() -> tuple[Any, StableDiffusion_1]:
    """The reduced SD1.5 (text encoder stubbed) in both packages, DDIM 10 steps."""
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_1(unet=JaxSD1UNet(in_channels=4, base_channels=32), lda=JaxSD1Autoencoder(),
                                  clip_text_encoder=jfl.Chain(jfl.Identity()), solver=JaxDDIM(num_inference_steps=STEPS))  # fmt: skip
    sd = StableDiffusion_1(unet=SD1UNet(in_channels=4, base_channels=32), lda=SD1Autoencoder(), clip_text_encoder=_stub(),
                           solver=DDIM(num_inference_steps=STEPS), device="cpu")  # fmt: skip
    _bridge(sd.unet, jax_sd.unet)
    _bridge(sd.lda, jax_sd.lda)
    return jax_sd, sd


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(11)
    return {"x": rs.randn(1, LATENT, LATENT, 4).astype(np.float32), "emb": rs.randn(2, 77, 768).astype(np.float32),
            "llm": DAMP * rs.randn(2, 12, 2048).astype(np.float32)}  # fmt: skip


def _predict(jax_sd: Any, sd: StableDiffusion_1, x: np.ndarray, emb: np.ndarray, scale: float = 7.5) -> tuple[np.ndarray, np.ndarray]:  # fmt: skip
    """`predict_noise` (CFG) in both packages, NHWC."""
    want = np.asarray(jax_sd.predict_noise(jnp.asarray(x), STEP, clip_text_embedding=jnp.asarray(emb), condition_scale=scale))
    with torch.inference_mode():
        got = sd.predict_noise(torch.tensor(nhwc_to_nchw(x)), STEP, clip_text_embedding=torch.tensor(emb),
                               condition_scale=scale)  # fmt: skip
    return nchw_to_nhwc(got.numpy()), want


def test_sd1_ella_adapter_step_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """A CFG step with `SD1ELLAAdapter` at its full widths, damped ×0.2:
    the UNet's state dict after injection (ELLA first in it) bridges with
    strict=True; the step matches, moves off the bare step, and the eject
    restores the bare step bit for bit."""
    jax_sd, sd = models
    bare, _ = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    jax_manual_seed(12)
    jax_adapter = JaxSD1ELLAAdapter(jax_sd.unet).inject()
    encoder = jax_adapter.latents_encoder
    encoder.load_state_dict({k: DAMP * jnp.asarray(v) for k, v in encoder.state_dict().items()})
    adapter = SD1ELLAAdapter(sd.unet).inject()
    assert isinstance(sd.unet[0], ELLA) and len(adapter.sub_adapters) == len(jax_adapter.sub_adapters) == 32
    assert adapter.latents_encoder.device == torch.device("cpu")
    _bridge(sd.unet, jax_sd.unet)  # ELLA's keys are the UNet's after injection
    jax_adapter.set_llm_text_embedding(jnp.asarray(inputs["llm"]))
    adapter.set_llm_text_embedding(torch.tensor(inputs["llm"]))
    got, want = _predict(jax_sd, sd, inputs["x"], inputs["emb"])
    latents = sd.unet.use_context("ella")["latents"]
    assert latents.shape == (2, 64, 768)
    jax_adapter.eject()
    adapter.eject()
    assert not any(k.startswith("ELLA") for k in sd.unet.state_dict())
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_predict(jax_sd, sd, inputs["x"], inputs["emb"])[0], bare)


def test_ella_inject_eject_keys_on_meta(models: tuple[Any, StableDiffusion_1]) -> None:
    """At full width, no memory: injection adds exactly the JAX adapter's
    ELLA keys (taken on the reduced UNet: the encoder's widths are its own)
    with their shapes, and moves no other key; eject restores the keys."""
    jax_sd, _ = models
    unet = SD1UNet(in_channels=4, device="meta")
    before = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    adapter = SD1ELLAAdapter(unet)
    assert adapter.latents_encoder.device == torch.device("meta")
    # the adapter holds the UNet and registers nothing of its own
    assert sorted(adapter.state_dict()) == sorted(f"SD1UNet.{k}" for k in before)
    adapter.inject()
    after = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    jax_manual_seed(13)
    jax_adapter = JaxSD1ELLAAdapter(jax_sd.unet).inject()
    want = {k: np.asarray(v).shape for k, v in jax_sd.unet.state_dict().items() if k.startswith("ELLA.")}
    jax_adapter.eject()
    layouts = _weight_layouts(adapter.latents_encoder)
    added = {k: v for k, v in after.items() if k not in before}
    assert sorted(added) == sorted(want) and {k: v for k, v in after.items() if k in before} == before
    for key, shape in want.items():
        local = key.removeprefix("ELLA.")
        assert added[key] == (tuple(shape[i] for i in layouts[local]) if local in layouts else shape), key
    assert sum(1 for _ in unet.layers(ella_adapter.ELLACrossAttentionAdapter, recurse=True)) == 32
    adapter.eject()
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == before
    assert isinstance(adapter, ELLAAdapter) and not any(True for _ in unet.layers(ELLA, recurse=True))


# -- IC-Light --------------------------------------------------------------------------


def _condition_image() -> tuple[Image.Image, Image.Image]:
    g = np.random.RandomState(61)
    image = Image.fromarray((g.rand(8 * LATENT, 8 * LATENT, 3) * 255).astype(np.uint8))
    mask = Image.fromarray((np.indices((8 * LATENT, 8 * LATENT)).sum(0) % 2 * 255).astype(np.uint8), mode="L")
    return image, mask


def test_ic_light_matches_jax(models: tuple[Any, StableDiffusion_1], inputs: dict[str, np.ndarray]) -> None:
    """`ICLight` from the reduced UNet: conv_in widened to 8 channels (its 4
    new ones zero) plus one patch given to each package in its layout, then
    a CFG step (scale 2.0) on a gray composite's latents."""
    jax_sd, sd = models
    jax_manual_seed(14)
    jax_unet, unet = JaxSD1UNet(in_channels=4, base_channels=32), SD1UNet(in_channels=4, base_channels=32)
    _bridge(unet, jax_unet)
    base = unet.state_dict()[CONV_IN].clone()
    shapes = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    shapes[CONV_IN] = (32, 8, 3, 3)
    rs = np.random.RandomState(60)
    patch = {k: (0.02 * rs.randn(*shape)).astype(np.float32) for k, shape in sorted(shapes.items())}
    kwargs = dict(lda=sd.lda, clip_text_encoder=_stub(), solver=DDIM(num_inference_steps=STEPS))
    ic = ICLight(patch_weights={k: torch.tensor(v) for k, v in patch.items()}, unet=unet, device="cpu", **kwargs)
    conv = ic.unet.ensure_find(DownBlocks).layer(0, fl.Chain).ensure_find(fl.Conv2d)
    assert conv.in_channels == 8 and ic.unet.device == torch.device("cpu")
    torch.testing.assert_close(conv.weight[:, :4], base + torch.tensor(patch[CONV_IN][:, :4]), rtol=0, atol=1e-7)
    torch.testing.assert_close(conv.weight[:, 4:], torch.tensor(patch[CONV_IN][:, 4:]), rtol=0, atol=0)
    jax_ic = JaxICLight(patch_weights={k: jnp.asarray(v) for k, v in _to_jax_layout(ic.unet, patch).items()},
                        unet=jax_unet, lda=jax_sd.lda, clip_text_encoder=jfl.Chain(jfl.Identity()),
                        solver=JaxDDIM(num_inference_steps=STEPS))  # fmt: skip
    want_state = {k: np.asarray(v) for k, v in jax_ic.unet.state_dict().items()}
    for key, value in _to_jax_layout(ic.unet, {k: v.numpy() for k, v in ic.unet.state_dict().items()}).items():
        np.testing.assert_allclose(value, want_state[key], rtol=0, atol=1e-6, err_msg=key)

    image, mask = _condition_image()
    jax_ic.set_ic_light_condition(image, mask)
    with torch.inference_mode():
        ic.set_ic_light_condition(image, mask)
    condition = nchw_to_nhwc(ic._ic_light_condition.numpy())
    assert condition.shape == (1, LATENT, LATENT, 4) and _rel(condition, np.asarray(jax_ic._ic_light_condition)) <= TOL
    got, want = _predict(jax_ic, ic, inputs["x"], inputs["emb"], scale=2.0)
    with torch.inference_mode():
        ic._ic_light_condition = torch.zeros_like(ic._ic_light_condition)
        unlit = ic.predict_noise(torch.tensor(nhwc_to_nchw(inputs["x"])), STEP,
                                 clip_text_embedding=torch.tensor(inputs["emb"]), condition_scale=2.0)  # fmt: skip
    assert _rel(got, want) <= TOL and _rel(got, nchw_to_nhwc(unlit.numpy())) > 1e-3


def test_ic_light_gray_composite_is_exact() -> None:
    image, mask = _condition_image()
    got = np.asarray(ICLight.compute_gray_composite(image=image, mask=mask))
    np.testing.assert_array_equal(got, np.asarray(JaxICLight.compute_gray_composite(image=image, mask=mask)))
    assert tuple(got[0, 0]) == (127, 127, 127) and tuple(got[0, 1]) == tuple(np.asarray(image)[0, 1])


def test_ic_light_and_ella_build_on_the_card_by_default() -> None:
    """With no device the facade moves its parts to `cuda`, and ELLA's
    encoder follows its UNet there; with no card, building raises."""
    unet = SD1UNet(in_channels=4, base_channels=32)
    patch = {k: torch.zeros(v.shape) for k, v in unet.state_dict().items()}
    patch[CONV_IN] = torch.zeros((32, 8, 3, 3))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ICLight(patch_weights=patch, unet=unet, lda=SD1Autoencoder(), clip_text_encoder=_stub())
        return
    ic = ICLight(patch_weights=patch, unet=unet, lda=SD1Autoencoder(), clip_text_encoder=_stub())
    assert {p.device.type for p in ic.parameters()} == {"cuda"}
    assert SD1ELLAAdapter(ic.unet).latents_encoder.device.type == "cuda"


# -- InformativeDrawings, Module.load_from_safetensors --------------------------------------


def test_informative_drawings_matches_jax() -> None:
    """Full width (3 residual blocks of 256) on a 64 × 48 image."""
    jax_manual_seed(20)
    jax_net, net = JaxInformativeDrawings(), InformativeDrawings()
    _bridge(net, jax_net)
    x = np.random.RandomState(21).rand(1, 3, 48, 64).astype(np.float32)
    want = np.asarray(jax_net(jnp.asarray(nchw_to_nhwc(x))))
    with torch.no_grad():
        got = net(torch.tensor(x)).numpy()
    assert got.shape == (1, 1, 48, 64) and _rel(nchw_to_nhwc(got), want) <= TOL


def test_load_from_safetensors_matches_jax(tmp_path: Path) -> None:
    """Each package reads its own layout's file (the JAX package writes
    its own layout, the port the torch one); both models then agree."""
    jax_manual_seed(22)
    kwargs = dict(embedding_dim=768, num_layers=2, num_attention_heads=12)
    source = JaxCLIPTextEncoder(**kwargs)
    jax_save_to_safetensors(tmp_path / "jax.safetensors", source.state_dict())
    bridged = CLIPTextEncoder(**kwargs)
    _bridge(bridged, source)
    save_to_safetensors(tmp_path / "port.safetensors", bridged.state_dict())
    jax_manual_seed(23)
    jax_encoder, encoder = JaxCLIPTextEncoder(**kwargs), CLIPTextEncoder(**kwargs)
    assert jax_encoder.load_from_safetensors(tmp_path / "jax.safetensors") is jax_encoder
    assert encoder.load_from_safetensors(tmp_path / "port.safetensors") is encoder
    for key, value in encoder.state_dict().items():
        assert torch.equal(value, bridged.state_dict()[key]), key
    want = np.asarray(jax_encoder("a cute cat, best quality"))
    with torch.no_grad():
        got = encoder("a cute cat, best quality").numpy()
    assert _rel(got, want) <= TOL
    # strict: a file with a key missing raises, unless strict=False
    state = bridged.state_dict()
    state.pop(next(iter(state)))
    save_to_safetensors(tmp_path / "partial.safetensors", state)
    with pytest.raises(RuntimeError, match="Missing key"):
        CLIPTextEncoder(**kwargs).load_from_safetensors(tmp_path / "partial.safetensors")
    CLIPTextEncoder(**kwargs).load_from_safetensors(tmp_path / "partial.safetensors", strict=False)
