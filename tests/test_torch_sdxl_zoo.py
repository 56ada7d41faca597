"""The port's SDXL adapter zoo against the JAX package, on the CPU.

Self-attention guidance (alone, beside an IP-Adapter, enabled again), the
T2I-Adapter, IP-Adapter ± plus, SDXL LoRAs through `SDLoraManager`, the LCM
adapter, LCM-LoRA (`add_lcm_lora`), MultiDiffusion and Control-LoRA (both
weight formats) on a reduced SDXL (`SDXLUNet(base_channels=32)`: the full
topology at 32/64/128 channels, one-layer text encoders, the VAE stubbed),
built in JAX from a seed and bridged into the port with strict=True, at
16×16 latents; the adapters' keys and shapes at full width on
`SDXLUNet(device="meta")` against `jax.eval_shape` of the JAX package's.
The JAX models run eagerly (SAG and the adapters' contexts live outside the
pytree a `jax.jit` would flatten). Float32 on both sides: modules 1e-5
relative, adapted steps and short trajectories 1e-4, each > 1e-3 from the
bare one; SAG's mask exactly; ejecting restores the bare step bit for bit.
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
from refiners_tpu.foundationals.clip import CLIPImageEncoder as JaxCLIPImageEncoder
from refiners_tpu.foundationals.clip.text_encoder import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu.foundationals.latent_diffusion import DDIM as JaxDDIM
from refiners_tpu.foundationals.latent_diffusion import DoubleTextEncoder as JaxDoubleTextEncoder
from refiners_tpu.foundationals.latent_diffusion import SDLoraManager as JaxSDLoraManager
from refiners_tpu.foundationals.latent_diffusion import SDXLUNet as JaxSDXLUNet
from refiners_tpu.foundationals.latent_diffusion import StableDiffusion_XL as JaxStableDiffusion_XL
from refiners_tpu.foundationals.latent_diffusion import stable_diffusion_xl as jax_xl
from refiners_tpu.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion as JaxMultiDiffusion
from refiners_tpu.foundationals.latent_diffusion.multi_diffusion import Size as JaxSize
from refiners_tpu.foundationals.latent_diffusion.solvers.lcm import LCMSolver as JaxLCMSolver
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_xl import control_lora as jax_control_lora
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_xl import lcm as jax_lcm
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_xl import lcm_lora as jax_lcm_lora
from refiners_tpu.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL as JaxConditionEncoderXL
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.conversion.jax_bridge import _weight_layouts
from refiners_tpu_torch.fluxion.adapters import LoraAdapter
from refiners_tpu_torch.foundationals.clip import CLIPImageEncoder, CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, LCMSolver, SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion import stable_diffusion_xl as xl
from refiners_tpu_torch.foundationals.latent_diffusion.cross_attention import CrossAttentionBlock
from refiners_tpu_torch.foundationals.latent_diffusion.image_prompt import CrossAttentionAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import MultiDiffusion, Size
from refiners_tpu_torch.foundationals.latent_diffusion.self_attention_guidance import (
    SelfAttentionMap,
    SelfAttentionShape,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import control_lora, lcm, lcm_lora
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLCrossAttention
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import ConditionEncoderXL, T2IFeatures
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualAccumulator, ResidualBlock

MODULE_TOL = 1e-5
# LCM's embedding at x = 6500: a float32 angle x·f is off by up to x·2⁻²⁴ ≈ 4e-4 rad, and XLA's
# float32 exp is not correctly rounded (the test prints at how many of the 128 frequencies): each
# package lies about 4e-5 from float64 there, and 3e-5 from the other
LCM_EMBEDDING_TOL = 1e-4
TOL = 1e-4
LATENT = 16  # the middle block at 4×4: 16 tokens in SAG's mask
STEPS = 3
STEP = 1
MASS_MARGIN = 1e-3  # every token's attention mass this far from SAG's threshold, so the mask is exact
RANK = 4
SAG_SCALE = 0.75
# the golden's reduced image encoder (tests/e2e/golden_cfg.py, build_ip_adapter_plus)
ENCODER = {"image_size": 32, "embedding_dim": 64, "output_dim": 48, "patch_size": 16, "num_layers": 32,
           "num_attention_heads": 4, "feedforward_dim": 128}  # fmt: skip
T2I_CHANNELS = (32, 64, 128, 128)  # the reduced UNet's widths


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


def _text_encoder(encoder: Any, tokenizer: Any, double: Any) -> Any:
    small = dict(num_layers=1, vocabulary_size=1000, feedforward_dim=64)
    text_l = encoder(embedding_dim=768, num_attention_heads=12, use_quick_gelu=True, **small)
    text_g = encoder(embedding_dim=1280, num_attention_heads=20, tokenizer=tokenizer(pad_token_id=0), **small)
    return double(text_encoder_l=text_l, text_encoder_g=text_g)


@pytest.fixture(scope="module")
def models() -> tuple[Any, xl.StableDiffusion_XL]:
    """The reduced SDXL in both packages, DDIM 3 steps, the VAE stubbed (every test stays in latents)."""
    jax_manual_seed(0)
    jax_sd = JaxStableDiffusion_XL(
        unet=JaxSDXLUNet(in_channels=4, base_channels=32),
        lda=jfl.Chain(jfl.Identity()),  # type: ignore[arg-type]
        clip_text_encoder=_text_encoder(JaxCLIPTextEncoder, JaxCLIPTokenizer, JaxDoubleTextEncoder),
        solver=JaxDDIM(num_inference_steps=STEPS),
    )
    sd = xl.StableDiffusion_XL(
        unet=xl.SDXLUNet(in_channels=4, base_channels=32),
        lda=fl.Chain(fl.Identity()),  # type: ignore[arg-type]
        clip_text_encoder=_text_encoder(CLIPTextEncoder, CLIPTokenizer, xl.DoubleTextEncoder),
        solver=DDIM(num_inference_steps=STEPS),
        device="cpu",
    )
    _bridge(sd.unet, jax_sd.unet)
    _bridge(sd.clip_text_encoder, jax_sd.clip_text_encoder)
    return jax_sd, sd


@pytest.fixture(scope="module")
def inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(11)
    return {"x": rs.randn(1, LATENT, LATENT, 4).astype(np.float32), "emb": rs.randn(2, 77, 2048).astype(np.float32),
            "pooled": rs.randn(2, 1280).astype(np.float32),
            "time_ids": np.array([[1024, 1024, 0, 0, 1024, 1024]] * 2, dtype=np.float32),
            "image_tokens": rs.randn(1, 4, 2048).astype(np.float32),
            "condition": rs.rand(1, 8 * LATENT, 8 * LATENT, 3).astype(np.float32)}  # fmt: skip


def _kwargs(inputs: dict[str, np.ndarray], port: bool, batch: slice = slice(None)) -> dict[str, Any]:
    to = torch.tensor if port else jnp.asarray
    return {"clip_text_embedding": to(inputs["emb"][batch]), "pooled_text_embedding": to(inputs["pooled"][batch]),
            "time_ids": to(inputs["time_ids"][batch])}  # fmt: skip


def _predict(jax_sd: Any, sd: xl.StableDiffusion_XL, inputs: dict[str, np.ndarray], x: np.ndarray | None = None,
             step: int = STEP) -> tuple[np.ndarray, np.ndarray]:  # fmt: skip
    """`predict_noise` (CFG 5.0) in both packages, NHWC."""
    x = inputs["x"] if x is None else x
    want = np.asarray(jax_sd.predict_noise(jnp.asarray(x), step, condition_scale=5.0, **_kwargs(inputs, False)))
    with torch.inference_mode():
        got = sd.predict_noise(torch.tensor(nhwc_to_nchw(x)), step, condition_scale=5.0, **_kwargs(inputs, True))
    return nchw_to_nhwc(got.numpy()), want


def _port_predict(sd: xl.StableDiffusion_XL, inputs: dict[str, np.ndarray]) -> np.ndarray:
    with torch.inference_mode():
        got = sd.predict_noise(torch.tensor(nhwc_to_nchw(inputs["x"])), STEP, condition_scale=5.0, **_kwargs(inputs, True))
    return nchw_to_nhwc(got.numpy())


def _port_trajectory(sd: xl.StableDiffusion_XL, inputs: dict[str, np.ndarray]) -> np.ndarray:
    """Every DDIM step (CFG 5.0) from `x`, NHWC."""
    got = torch.tensor(nhwc_to_nchw(inputs["x"]))
    for step in sd.steps:
        with torch.inference_mode():
            got = sd(got, step, condition_scale=5.0, **_kwargs(inputs, True))
    return nchw_to_nhwc(got.numpy())


def _jax_trajectory(jax_sd: Any, inputs: dict[str, np.ndarray]) -> np.ndarray:
    want = jnp.asarray(inputs["x"])
    for step in jax_sd.steps:
        want = jax_sd(want, step, condition_scale=5.0, **_kwargs(inputs, False))
    return np.asarray(want)


# -- self-attention guidance ----------------------------------------------------

_JAX_SAG: dict[int, Any] = {}


def _jax_sag(jax_sd: Any, enable: bool) -> None:
    """JAX's SAG at 0.75 on `jax_sd`, one adapter per model, injected or
    ejected. The JAX package's `set_self_attention_guidance(True)` after a
    `False` builds a second adapter, which reads a context its recorders no
    longer write (ROADMAP Queue 3; the port's facade is held to it in
    `test_sdxl_sag_can_be_enabled_again`); re-injecting the first adapter avoids it."""
    sag = _JAX_SAG.setdefault(id(jax_sd), jax_xl.SDXLSAGAdapter(jax_sd.unet, scale=SAG_SCALE))
    if enable:
        sag.inject()
    else:
        sag.eject()


def test_sdxl_sag_map_mask_and_trajectory_match_jax(
    models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]
) -> None:
    """The middle block's attention map after one CFG UNet call, SAG's mask
    from it exactly (every token's mass, averaged over heads and summed over
    queries, at least `MASS_MARGIN` from the threshold 1), then 3 DDIM steps
    with SAG at 0.75."""
    jax_sd, sd = models
    bare = _port_trajectory(sd, inputs)
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=SAG_SCALE)
    jax_sag, sag = jax_sd._find_sag_adapter(), sd._find_sag_adapter()
    assert jax_sag is not None and isinstance(sag, xl.SDXLSAGAdapter)
    x2 = np.concatenate([inputs["x"], inputs["x"]])
    jax_sd.set_unet_context(timestep=jax_sd.solver.timesteps[STEP][None], **_kwargs(inputs, False))
    jax_sd.unet(jnp.asarray(x2))
    with torch.inference_mode():
        sd.set_unet_context(timestep=sd.solver.timesteps[STEP][None], **_kwargs(inputs, True))
        sd.unet(torch.tensor(nhwc_to_nchw(x2)))
    want_map = np.asarray(jax_sag.use_context("self_attention_map")["middle_block_attn_map"])
    got_map = sd.unet.use_context("self_attention_map")["middle_block_attn_map"].numpy()
    assert got_map.shape == want_map.shape == (2, 2, 16, 16) and _rel(got_map, want_map) <= TOL
    mass = want_map[:1].mean(axis=1).sum(axis=1)
    assert np.abs(mass - 1.0).min() >= MASS_MARGIN and 0 < (mass > 1.0).sum() < mass.size
    assert sd.unet.use_context("self_attention_map")["middle_block_attn_shape"] == [(4, 4)]
    want_mask = np.asarray(jax_sag.compute_sag_mask(jnp.asarray(inputs["x"])))
    got_mask = sag.compute_sag_mask(torch.tensor(nhwc_to_nchw(inputs["x"])))
    assert got_mask.shape == (1, 4, LATENT, LATENT)
    np.testing.assert_array_equal(nchw_to_nhwc(got_mask.numpy()), want_mask)
    got, want = _port_trajectory(sd, inputs), _jax_trajectory(jax_sd, inputs)
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_port_trajectory(sd, inputs), bare)


def _stand_in_encoders() -> list[Any]:
    """An image encoder of ViT-H's widths that is never called (the image tokens are given)."""
    encoders = []
    for ns in (jfl, fl):
        enc = ns.Chain()
        enc.embedding_dim, enc.output_dim = 1280, 1024  # type: ignore[attr-defined]
        encoders.append(enc)
    return encoders


def test_sdxl_sag_with_ip_adapter_matches_jax(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """SAG beside an IP-Adapter: the degraded call takes the negative half of the image tokens too."""
    jax_sd, sd = models
    jax_encoder, encoder = _stand_in_encoders()
    jax_manual_seed(12)
    jax_ip = jax_xl.SDXLIPAdapter(jax_sd.unet, clip_image_encoder=jax_encoder).inject()
    ip = xl.SDXLIPAdapter(sd.unet, clip_image_encoder=encoder).inject()
    _bridge(sd.unet, jax_sd.unet)  # the image keys' and values' projections
    tokens = np.concatenate([np.zeros_like(inputs["image_tokens"]), inputs["image_tokens"]])
    jax_ip.set_clip_image_embedding(jnp.asarray(tokens))
    ip.set_clip_image_embedding(torch.tensor(tokens))
    without_sag = _port_predict(sd, inputs)
    _jax_sag(jax_sd, True)
    sd.set_self_attention_guidance(True, scale=SAG_SCALE)
    got, want = _predict(jax_sd, sd, inputs)
    assert ip.use_context("ip_adapter")["clip_image_embedding"].shape == (2, 4, 2048)  # restored after the split
    _jax_sag(jax_sd, False)
    sd.set_self_attention_guidance(False)
    jax_ip.eject()
    ip.eject()
    assert _rel(got, want) <= TOL and _rel(got, without_sag) > 1e-3


def test_sdxl_sag_can_be_enabled_again(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """The facade's SAG enabled, disabled and enabled again (a new adapter
    around the same UNet) gives the same step both times, bit for bit, and
    JAX's step (its one adapter re-injected)."""
    jax_sd, sd = models
    steps = []
    for _ in range(2):
        sd.set_self_attention_guidance(True, scale=SAG_SCALE)
        steps.append(_port_predict(sd, inputs))
        sd.set_self_attention_guidance(False)
    np.testing.assert_array_equal(steps[0], steps[1])
    _jax_sag(jax_sd, True)
    want = np.asarray(jax_sd.predict_noise(jnp.asarray(inputs["x"]), STEP, condition_scale=5.0, **_kwargs(inputs, False)))
    _jax_sag(jax_sd, False)
    assert _rel(steps[1], want) <= TOL


def test_set_self_attention_guidance_on_sdxl() -> None:
    """Enabling injects one adapter (a second call only sets its scale); disabling ejects it."""
    sd = xl.StableDiffusion_XL(unet=xl.SDXLUNet(in_channels=4, base_channels=32), lda=fl.Chain(fl.Identity()),  # type: ignore[arg-type]
                               clip_text_encoder=fl.Chain(fl.Identity()), device="cpu")  # type: ignore[arg-type]  # fmt: skip
    assert not sd.has_self_attention_guidance()
    sd.set_self_attention_guidance(True, scale=0.5)
    sd.set_self_attention_guidance(True, scale=0.75)
    assert sd.has_self_attention_guidance() and sd._find_sag_adapter().scale == 0.75  # type: ignore[union-attr]
    assert len(list(sd.unet.layers(SelfAttentionMap, recurse=True))) == 1
    assert len(list(sd.unet.layers(SelfAttentionShape, recurse=True))) == 1
    sd.set_self_attention_guidance(False)
    assert not sd.has_self_attention_guidance() and sd.unet.parent is None
    assert not list(sd.unet.layers(SelfAttentionMap, recurse=True))


# -- T2I-Adapter and IP-Adapter -------------------------------------------------


def test_sdxl_t2i_adapter_matches_jax(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """`SDXLT2IAdapter` with an encoder of the reduced UNet's widths: its 4
    feature maps (module tolerance), a CFG step at scale 0.8, a second
    injection under the same name refused, and eject."""
    jax_sd, sd = models
    bare = _port_predict(sd, inputs)
    jax_manual_seed(13)
    jax_adapter = jax_xl.SDXLT2IAdapter(jax_sd.unet, name="canny", scale=0.8,
                                        condition_encoder=JaxConditionEncoderXL(channels=T2I_CHANNELS)).inject()  # fmt: skip
    adapter = xl.SDXLT2IAdapter(sd.unet, name="canny", scale=0.8,
                                condition_encoder=ConditionEncoderXL(channels=T2I_CHANNELS)).inject()  # fmt: skip
    _bridge(adapter.condition_encoder, jax_adapter.condition_encoder)
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())
    assert [f.parent.get_path(top=sd.unet) for f in sd.unet.layers(T2IFeatures, recurse=True)] == [
        "SDXLUNet.DownBlocks.Chain_4", "SDXLUNet.DownBlocks.Chain_6", "SDXLUNet.DownBlocks.Chain_9", "SDXLUNet.MiddleBlock"]  # fmt: skip
    condition = inputs["condition"]
    want_features = jax_adapter.compute_condition_features(jnp.asarray(condition))
    with torch.inference_mode():
        features = adapter.compute_condition_features(torch.tensor(nhwc_to_nchw(condition)))
    assert [tuple(f.shape) for f in features] == [(1, 32, 8, 8), (1, 64, 8, 8), (1, 128, 4, 4), (1, 128, 4, 4)]
    for f, w in zip(features, want_features, strict=True):
        assert _rel(nchw_to_nhwc(f.numpy()), np.asarray(w)) <= MODULE_TOL
    jax_adapter.set_condition_features(want_features)
    adapter.set_condition_features(features)
    got, want = _predict(jax_sd, sd, inputs)
    with pytest.raises(AssertionError, match="already injected"):
        xl.SDXLT2IAdapter(sd.unet, name="canny", condition_encoder=adapter.condition_encoder).inject()
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    assert not list(sd.unet.layers(T2IFeatures, recurse=True))
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)


@pytest.mark.parametrize("fine_grained", [False, True], ids=["ip_adapter", "plus"])
def test_sdxl_ip_adapter_matches_jax(
    fine_grained: bool, models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]
) -> None:
    """`SDXLIPAdapter` with the golden's reduced image encoder and the
    default projection (plus: a perceiver of width 1280, not 2048): the
    image embedding (negative ‖ conditional), a CFG step, scale 0, eject."""
    jax_sd, sd = models
    bare = _port_predict(sd, inputs)
    jax_manual_seed(14 + fine_grained)
    jax_encoder, encoder = JaxCLIPImageEncoder(**ENCODER), CLIPImageEncoder(**ENCODER)
    _bridge(encoder, jax_encoder)
    jax_adapter = jax_xl.SDXLIPAdapter(jax_sd.unet, clip_image_encoder=jax_encoder, fine_grained=fine_grained).inject()
    adapter = xl.SDXLIPAdapter(sd.unet, clip_image_encoder=encoder, fine_grained=fine_grained).inject()
    _bridge(adapter.image_proj, jax_adapter.image_proj)
    _bridge(sd.unet, jax_sd.unet)  # the image keys' and values' projections
    assert len(adapter.sub_adapters) == 70 and isinstance(adapter.sub_adapters[0], CrossAttentionAdapter)
    if fine_grained:
        assert adapter.image_proj.layer(("Linear_1",), fl.Linear).out_features == 1280
    image = np.random.RandomState(15).randn(1, 32, 32, 3).astype(np.float32)
    want_embedding = jax_adapter.compute_clip_image_embedding(jnp.asarray(image))
    with torch.inference_mode():
        embedding = adapter.compute_clip_image_embedding(torch.tensor(nhwc_to_nchw(image)))
    assert embedding.shape == (2, 16 if fine_grained else 4, 2048)
    assert _rel(embedding.numpy(), np.asarray(want_embedding)) <= MODULE_TOL
    jax_adapter.set_clip_image_embedding(want_embedding)
    adapter.set_clip_image_embedding(embedding)
    got, want = _predict(jax_sd, sd, inputs)
    adapter.scale = 0.0
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)
    jax_adapter.eject()
    adapter.eject()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)


# -- LoRAs: SDLoraManager and add_lcm_lora --------------------------------------


def _weights(shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]], seed: int, std: float = 0.1) -> dict[str, np.ndarray]:
    """`key.lora_down.weight` and `key.lora_up.weight` in the reference's (torch) layout."""
    rs = np.random.RandomState(seed)
    out: dict[str, np.ndarray] = {}
    for key, (down, up) in shapes.items():
        out[f"{key}.lora_down.weight"] = (rs.randn(*down) * std).astype(np.float32)
        out[f"{key}.lora_up.weight"] = (rs.randn(*up) * std).astype(np.float32)
    return out


def _middle_width_transformers(unet: xl.SDXLUNet) -> list[SDXLCrossAttention]:
    """The transformers at the UNet's middle width (2 down, 3 up; 2 blocks
    each): the only layers of their shapes, so a LoRA on them alone attaches
    each key to its layer (attaching is quadratic in the keys: all 70 blocks
    would take minutes in each package)."""
    width = 2 * unet.base_channels
    return [a for a in unet.layers(SDXLCrossAttention, recurse=True) if a.channels == width]


def _sdxl_lora_dict(sd: xl.StableDiffusion_XL, seed: int) -> dict[str, np.ndarray]:
    """A kohya-style SDXL LoRA: every Linear of the UNet's middle-width
    transformers (their projections in and out, attention and feed-forward),
    every convolution of its ResidualBlocks ("res" keys), and every Linear of
    CLIP-L (`lora_te1_*`) and of CLIP-G (`lora_te2_*`), named in the order of
    the tree so that each key attaches to its layer."""
    shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {}
    linears = [l for block in _middle_width_transformers(sd.unet) for l in block.layers(fl.Linear, recurse=True)]
    for n, linear in enumerate(linears):
        shapes[f"lora_unet_L{n:04d}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
    convs = [c for block in sd.unet.layers(ResidualBlock, recurse=True) for c in block.layers(fl.Conv2d, recurse=True)]
    for n, conv in enumerate(convs):
        shapes[f"lora_unet_res_R{n:04d}"] = ((RANK, conv.in_channels, 3, 3), (conv.out_channels, RANK, 1, 1))
    parallel = sd.clip_text_encoder.layer("Parallel", fl.Parallel)
    for prefix, encoder in (("lora_te1_text", parallel[0]), ("lora_te2_text", parallel[1])):
        for n, linear in enumerate(encoder.layers(fl.Linear, recurse=True)):
            shapes[f"{prefix}_T{n:04d}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
    return _weights(shapes, seed)


def _add_loras(manager: Any, lora_cls: Any, name: str, tensors: dict[str, Any], scale: float) -> list[tuple[str, str]]:
    """`SDLoraManager.add_loras`, step by step, keeping the attach map."""
    debug_map: list[tuple[str, str]] = []
    loras = lora_cls.from_dict(name, state_dict=tensors)
    loras = {key: loras[key] for key in sorted(loras.keys(), key=manager.sort_keys)}
    manager.add_loras_to_unet(loras, debug_map=debug_map)
    manager.add_loras_to_text_encoder(loras, debug_map=debug_map)
    manager.set_scale(name, scale)
    return debug_map


def test_sdxl_loras_match_jax(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """A LoRA at 0.8 on the UNet and both text encoders: the attach map key for key, each text-encoder key in its own CLIP, the keys
    of every state dict, a CFG step; `remove_all` restores the bare step."""
    from refiners_tpu.fluxion.adapters import Lora as JaxLora
    from refiners_tpu_torch.fluxion.adapters import Lora

    jax_sd, sd = models
    bare = _port_predict(sd, inputs)
    jax_manager, manager = JaxSDLoraManager(jax_sd), SDLoraManager(sd)
    weights = _sdxl_lora_dict(sd, seed=16)
    want_map = _add_loras(jax_manager, JaxLora, "style", {k: jnp.asarray(v) for k, v in weights.items()}, 0.8)
    got_map = _add_loras(manager, Lora, "style", {k: torch.tensor(v) for k, v in weights.items()}, 0.8)
    assert got_map == want_map and len(got_map) == len(weights) // 2
    paths = dict(got_map)
    assert all(".Parallel.Chain." in paths[k] for k in paths if k.startswith("lora_te1"))
    assert all(".Parallel.TextEncoderWithPooling." in paths[k] for k in paths if k.startswith("lora_te2"))
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())
    assert list(sd.clip_text_encoder.state_dict()) == list(jax_sd.clip_text_encoder.state_dict())
    assert manager.scales == {"style": 0.8}
    got, want = _predict(jax_sd, sd, inputs)
    jax_manager.remove_all()
    manager.remove_all()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    assert manager.lora_adapters == []
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)


def _lcm_lora_dict(unet: xl.SDXLUNet, seed: int) -> dict[str, np.ndarray]:
    """An LCM-LoRA of diffusers' key names (`lora_unet_down_blocks_1_attentions_0_proj_in`, ...):
    each middle-width transformer's projections and the Linears of its blocks."""
    middle = _middle_width_transformers(unet)
    blocks = {"DownBlocks": [0, 0, 0, 0, 1, 1, 1, 2, 2], "UpBlocks": [0, 0, 0, 1, 1, 1, 2, 2, 2]}
    diffusers = {"DownBlocks": "down_blocks", "UpBlocks": "up_blocks"}
    shapes: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {}
    attentions: dict[str, int] = {}
    for name in ("DownBlocks", "MiddleBlock", "UpBlocks"):
        chains = [unet.layer(name, fl.Chain)] if name == "MiddleBlock" else list(unet.layer(name, fl.Chain))
        for i, chain in enumerate(chains):
            for attention in chain.layers(SDXLCrossAttention):
                if attention not in middle:
                    continue
                block = "mid_block" if name == "MiddleBlock" else f"{diffusers[name]}_{blocks[name][i]}"
                prefix = f"lora_unet_{block}_attentions_{attentions.setdefault(block, 0)}"
                attentions[block] += 1
                linears = list(attention.layers(fl.Linear, recurse=True))
                proj_in, proj_out = linears[0], linears[-1]
                for suffix, linear in (("proj_in", proj_in), ("proj_out", proj_out)):
                    shapes[f"{prefix}_{suffix}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
                for j, cross_attention in enumerate(attention.layers(CrossAttentionBlock, recurse=True)):
                    for n, linear in enumerate(cross_attention.layers(fl.Linear, recurse=True)):
                        shapes[f"{prefix}_transformer_blocks_{j}_lin_{n}"] = ((RANK, linear.in_features), (linear.out_features, RANK))
    return _weights(shapes, seed)


def test_add_lcm_lora_matches_jax(
    models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray], monkeypatch: pytest.MonkeyPatch
) -> None:
    """`add_lcm_lora` at its default scale (8/64) on a diffusers-named
    LoRA: the attach map `_check_validity` receives, key for key (each
    projection inside its SDXLCrossAttention, outside its transformer
    blocks), the UNet's keys, a CFG step; `_check_validity` rejects a key
    attached outside its block."""
    jax_sd, sd = models
    bare = _port_predict(sd, inputs)
    maps: dict[str, list[tuple[str, str]]] = {}
    for key, module in (("jax", jax_lcm_lora), ("port", lcm_lora)):
        check = module._check_validity
        monkeypatch.setattr(module, "_check_validity", lambda m, key=key, check=check: (maps.setdefault(key, list(m)), check(m)))
    weights = _lcm_lora_dict(sd.unet, seed=18)
    jax_manager, manager = JaxSDLoraManager(jax_sd), SDLoraManager(sd)
    jax_xl.add_lcm_lora(jax_manager, {k: jnp.asarray(v) for k, v in weights.items()})
    xl.add_lcm_lora(manager, {k: torch.tensor(v) for k, v in weights.items()})
    assert maps["port"] == maps["jax"] and len(maps["port"]) == len(weights) // 2
    paths = dict(maps["port"])
    assert paths["lora_unet_down_blocks_1_attentions_0_proj_in"].startswith("SDXLUNet.DownBlocks.Chain_5.SDXLCrossAttention.")
    assert all("CrossAttentionBlock" not in path for key, path in paths.items() if key.endswith(("proj_in", "proj_out")))
    assert manager.scales == {"lcm": 8.0 / 64.0}
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())
    got, want = _predict(jax_sd, sd, inputs)
    jax_manager.remove_all()
    manager.remove_all()
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)
    bad = [("lora_unet_mid_block_attentions_0_proj_in", "SDXLUNet.DownBlocks.Chain_8.SDXLCrossAttention.Linear")]
    for module in (jax_lcm_lora, lcm_lora):
        with pytest.raises(AssertionError, match="bad mapping"):
            module._check_validity(bad)
        module._check_validity([("lora_unet_up_blocks_2_resnets_0_conv1", "SDXLUNet.UpBlocks.Chain_8.ResidualBlock")])


# -- LCM ------------------------------------------------------------------------


def test_lcm_embedding_and_condition_scale_block_match_jax() -> None:
    """LCM's [sin | cos] embedding (the exponent over half_dim - 1) at the
    guidance scales 7.5 (x = 6500), 1 and 2, against a float64 evaluation and
    against JAX within `LCM_EMBEDDING_TOL`; `ConditionScaleBlock` on it."""
    x = np.array([6500.0, 0.0, 1000.0], dtype=np.float32)
    want = np.asarray(jax_lcm.compute_sinusoidal_embedding(jnp.asarray(x), embedding_dim=256))
    got = lcm.compute_sinusoidal_embedding(torch.tensor(x), embedding_dim=256).numpy()
    angles = x[:, None].astype(np.float64) * np.exp(-np.log(10000) * np.arange(128) / 127)[None]
    exact = np.concatenate([np.sin(angles), np.cos(angles)], axis=-1)
    assert got.shape == (3, 256) and got.dtype == np.float32
    exponent = (-np.log(10000) * np.arange(128, dtype=np.float32) / 127).astype(np.float32)
    off = int((np.asarray(jnp.exp(jnp.asarray(exponent))) != np.exp(exponent.astype(np.float64)).astype(np.float32)).sum())
    print(f"LCM embedding: XLA's exp off the rounded float64 one at {off} of 128 frequencies; from float64 the port "
          f"{_rel(got, exact):.2e}, JAX {_rel(want, exact):.2e}; the port from JAX {_rel(got, want):.2e}")
    assert _rel(got, exact) <= LCM_EMBEDDING_TOL and _rel(want, exact) <= LCM_EMBEDDING_TOL
    assert _rel(got, want) <= LCM_EMBEDDING_TOL
    np.testing.assert_array_equal(got[1], want[1])  # x = 0: sin 0 and cos 0 exactly
    jax_manual_seed(19)
    jax_block = jfl.Chain(jax_lcm.ConditionScaleBlock(in_channels=256, out_channels=32))
    block = fl.Chain(lcm.ConditionScaleBlock(in_channels=256, out_channels=32))
    _bridge(block, jax_block)
    base = np.random.RandomState(20).randn(2, 32).astype(np.float32)
    jax_block.set_context("lcm", {"condition_scale_embedding": jnp.asarray(want[:1])})
    block.set_context("lcm", {"condition_scale_embedding": torch.tensor(want[:1])})
    with torch.no_grad():
        out = block(torch.tensor(base)).numpy()
    assert _rel(out, np.asarray(jax_block(jnp.asarray(base)))) <= MODULE_TOL and _rel(out, base) > 1e-3


def test_sdxl_lcm_adapter_matches_jax(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """`SDXLLcmAdapter` (guidance scale 7.5 as an embedding) with a 4-step
    `LCMSolver` and no classifier-free guidance, each step re-noised with the
    JAX key's noise handed to the port through `_renoising_noise`; the
    condition-scale setter; eject."""
    jax_sd, sd = models
    jax_manual_seed(21)
    jax_adapter = jax_xl.SDXLLcmAdapter(jax_sd.unet).inject()
    adapter = xl.SDXLLcmAdapter(sd.unet).inject()
    _bridge(sd.unet, jax_sd.unet)  # the ConditionScaleBlock's Linear
    assert [m.__class__.__name__ for m in sd.unet.layer(("TimestepEncoder", "Sum", "Chain", "RangeEncoder"), fl.Chain)] == [
        "Lambda", "Converter", "ConditionScaleBlock", "Linear", "SiLU", "Linear"]  # fmt: skip
    jax_lcm_sd = JaxStableDiffusion_XL(unet=jax_sd.unet, lda=jax_sd.lda, clip_text_encoder=jax_sd.clip_text_encoder,
                                       solver=JaxLCMSolver(num_inference_steps=4))  # fmt: skip
    lcm_sd = xl.StableDiffusion_XL(unet=sd.unet, lda=sd.lda, clip_text_encoder=sd.clip_text_encoder,
                                   solver=LCMSolver(num_inference_steps=4), device="cpu")  # fmt: skip
    jax_lcm_sd.classifier_free_guidance = lcm_sd.classifier_free_guidance = False
    x0, one = inputs["x"], slice(1, 2)
    keys = {step: jax.random.fold_in(jax.random.key(68), step) for step in jax_lcm_sd.steps}
    noises = iter(np.asarray(jax.random.normal(keys[s], x0.shape)) for s in lcm_sd.steps)
    lcm_sd.solver._renoising_noise = lambda generator, shape: torch.tensor(nhwc_to_nchw(next(noises)))  # type: ignore[method-assign]

    def trajectory() -> tuple[np.ndarray, np.ndarray]:
        want, got = jnp.asarray(x0), torch.tensor(nhwc_to_nchw(x0))
        for step in jax_lcm_sd.steps:
            noise = jax_lcm_sd.predict_noise(want, step, condition_scale=1.0, **_kwargs(inputs, False, one))
            want = jax_lcm_sd.solver(want, noise, step, key=keys[step])
            with torch.inference_mode():
                got = lcm_sd(got, step, condition_scale=1.0, **_kwargs(inputs, True, one))
        return nchw_to_nhwc(got.numpy()), np.asarray(want)

    got, want = trajectory()
    assert _rel(got, want) <= TOL
    adapter.set_condition_scale(4.0)
    embedding = adapter.use_context("lcm")["condition_scale_embedding"]
    np.testing.assert_array_equal(embedding.numpy(), lcm.compute_sinusoidal_embedding(torch.tensor([3000.0]), 256).numpy())
    jax_adapter.eject()
    adapter.eject()
    assert not list(sd.unet.layers(lcm.ConditionScaleBlock, recurse=True))
    assert list(sd.unet.state_dict()) == list(JaxSDXLUNet(in_channels=4, base_channels=32).state_dict())
    noises = iter(np.asarray(jax.random.normal(keys[s], x0.shape)) for s in lcm_sd.steps)
    bare, _ = trajectory()
    assert _rel(got, bare) > 1e-3


# -- MultiDiffusion ---------------------------------------------------------------


def test_sdxl_multi_diffusion_matches_jax(models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]) -> None:
    """Two 16² tiles over a 16 × 24 latent (overlap 8), each with its own
    DDIM, two steps at CFG 5.0; the model's solver is restored after each tile."""
    from refiners_tpu.foundationals.latent_diffusion.solvers import DDIM as JaxDDIMSolver

    jax_sd, sd = models
    tiles = MultiDiffusion.generate_latent_tiles(Size(16, 24), Size(16, 16), min_overlap=8)
    jax_tiles = JaxMultiDiffusion.generate_latent_tiles(JaxSize(16, 24), JaxSize(16, 16), min_overlap=8)
    assert [tuple(t) for t in tiles] == [tuple(t) for t in jax_tiles] == [(0, 0, 16, 16), (0, 8, 16, 24)]
    jax_md, md = jax_xl.SDXLMultiDiffusion(jax_sd), xl.SDXLMultiDiffusion(sd)
    jax_targets = [jax_xl.SDXLTarget(tile=t, solver=JaxDDIMSolver(num_inference_steps=STEPS), **_kwargs(inputs, False))
                   for t in jax_tiles]  # fmt: skip
    targets = [xl.SDXLTarget(tile=t, solver=DDIM(num_inference_steps=STEPS), **_kwargs(inputs, True)) for t in tiles]
    assert targets[0].condition_scale == 5.0
    noise = np.random.RandomState(22).randn(1, 16, 24, 4).astype(np.float32)
    solver = sd.solver
    want, got = jnp.asarray(noise), torch.tensor(nhwc_to_nchw(noise))
    for step in sd.steps[:2]:
        want = jax_md(want, noise=jnp.asarray(noise), step=step, targets=jax_targets)
        with torch.inference_mode():
            got = md(got, noise=torch.tensor(nhwc_to_nchw(noise)), step=step, targets=targets)
    assert sd.solver is solver
    got_nhwc = nchw_to_nhwc(got.numpy())
    assert got_nhwc.shape == (1, 16, 24, 4) and _rel(got_nhwc, np.asarray(want)) <= TOL
    assert _rel(got_nhwc, noise) > 1e-3


# -- Control-LoRA ----------------------------------------------------------------


def _eligible(control: Any, ns: Any, module: Any) -> list[Any]:
    """The Linears and Conv2ds of a ControlLora outside its zero convolutions
    and condition encoder, in the order of the tree: the layers its LoRAs attach to."""
    excluded = {id(w) for kind in (module.ConditionEncoder, module.ZeroConvolution)
                for sub in control.layers(kind, recurse=True) for w in sub.layers(ns.WeightedModule, recurse=True)}  # fmt: skip
    return [m for m, _ in control.walk(lambda m, _: isinstance(m, (ns.Linear, ns.Conv2d)), recurse=True) if id(m) not in excluded]


def _original_checkpoint(control: control_lora.ControlLora, seed: int) -> dict[str, np.ndarray]:
    """A stability-ai-format Control-LoRA shaped from the port's tree (torch
    layouts): a rank-4 `.down`/`.up` pair per eligible layer (conv LoRAs 3×3
    down, 1×1 up), `input_hint_block.{2i}`, `zero_convs.{i}.0` and `middle_block_out.0`."""
    rs = np.random.RandomState(seed)

    def t(*shape: int) -> np.ndarray:
        return (rs.randn(*shape) * 0.05).astype(np.float32)

    out: dict[str, np.ndarray] = {}
    for n, layer in enumerate(_eligible(control, fl, control_lora)):
        stem = f"lora.a{n:04d}"
        if isinstance(layer, fl.Linear):
            out[f"{stem}.down"], out[f"{stem}.up"] = t(RANK, layer.in_features), t(layer.out_features, RANK)
        else:
            kh, kw = layer.weight.shape[2:]
            out[f"{stem}.down"], out[f"{stem}.up"] = t(RANK, layer.in_channels, kh, kw), t(layer.out_channels, RANK, 1, 1)
    for i, conv in enumerate(control.ensure_find(control_lora.ConditionEncoder).layers(fl.Conv2d, recurse=True)):
        out[f"input_hint_block.{2 * i}.weight"], out[f"input_hint_block.{2 * i}.bias"] = t(*conv.weight.shape), t(conv.out_channels)
    zero_convs = [z.ensure_find(fl.Conv2d) for z in control.layers(control_lora.ZeroConvolution, recurse=True)]
    for i, conv in enumerate(zero_convs):
        stem = f"zero_convs.{i}.0" if i < len(zero_convs) - 1 else "middle_block_out.0"
        out[f"{stem}.weight"], out[f"{stem}.bias"] = t(*conv.weight.shape), t(conv.out_channels)
    return out


def _refiners_checkpoint(control: control_lora.ControlLora, seed: int) -> dict[str, np.ndarray]:
    """The same weights in the refiners layout: `ControlLora.<path>.down`/`.up`,
    `ZeroConvolution_NN.Conv2d.*`, `ConditionEncoder.<path>.*` (torch layouts)."""
    original = _original_checkpoint(control, seed)
    out: dict[str, np.ndarray] = {}
    eligible = {id(m) for m in _eligible(control, fl, control_lora)}
    for n, (layer, parent) in enumerate((m, p) for m, p in control.walk(recurse=True) if id(m) in eligible):
        path = layer.get_path(parent=parent, top=control)
        out[f"{path}.down"], out[f"{path}.up"] = original[f"lora.a{n:04d}.down"], original[f"lora.a{n:04d}.up"]
    encoder = control.ensure_find(control_lora.ConditionEncoder)
    for i, (conv, parent) in enumerate(encoder.walk(fl.Conv2d, recurse=True)):
        path = conv.get_path(parent=parent, top=encoder)
        out[f"{path}.weight"], out[f"{path}.bias"] = original[f"input_hint_block.{2 * i}.weight"], original[f"input_hint_block.{2 * i}.bias"]
    zero_convs = list(control.layers(control_lora.ZeroConvolution, recurse=True))
    for i in range(len(zero_convs)):
        stem = f"zero_convs.{i}.0" if i < len(zero_convs) - 1 else "middle_block_out.0"
        out[f"ZeroConvolution_{i + 1:02d}.Conv2d.weight"], out[f"ZeroConvolution_{i + 1:02d}.Conv2d.bias"] = original[f"{stem}.weight"], original[f"{stem}.bias"]  # fmt: skip
    return out


@pytest.mark.parametrize("layout", ["original", "refiners"])
def test_control_lora_matches_jax(
    layout: str, models: tuple[Any, xl.StableDiffusion_XL], inputs: dict[str, np.ndarray]
) -> None:
    """`ControlLoraAdapter` loaded in the port from a seeded checkpoint in
    stability-ai's original format (`load_original_weights`) or in the
    refiners layout (`load_weights`), and in JAX from the same weights in the
    refiners layout: the ControlLora's keys and weights equal (each LoRA on
    the same layer), a CFG step at scale 0.8 on a 128² condition, the scale
    setter, `structural_copy` refused; the half-UNet's base layers are the
    UNet's own tensors and its LoRAs leave the UNet's path untouched; eject
    restores the bare step bit for bit."""
    jax_sd, sd = models
    bare = _port_predict(sd, inputs)
    base_params = {p.data_ptr() for p in sd.unet.parameters()}
    jax_manual_seed(23)
    jax_adapter = jax_xl.ControlLoraAdapter(name="tile", target=jax_sd.unet, scale=0.8).inject()
    adapter = xl.ControlLoraAdapter(name="tile", target=sd.unet, scale=0.8).inject()
    control = adapter.control_lora
    assert sd.unet[0] is control and control.parent is sd.unet
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())
    shared = [p for layer in _eligible(control, fl, control_lora) for p in layer.parameters()]
    assert shared and all(p.data_ptr() in base_params for p in shared)
    n_eligible = len(_eligible(control, fl, control_lora))
    assert n_eligible == len(_eligible(jax_adapter.control_lora, jfl, jax_control_lora))
    # JAX loads the refiners layout (its original-format loader attaches the same LoRAs to the same
    # layers, held by its own tests, at minutes of host time for this tree)
    jax_adapter.load_weights({k: jnp.asarray(v) for k, v in _refiners_checkpoint(control, seed=24).items()})
    weights = _original_checkpoint(control, seed=24) if layout == "original" else _refiners_checkpoint(control, seed=24)
    if layout == "original":
        adapter.load_original_weights({k: torch.tensor(v) for k, v in weights.items()})
    else:
        adapter.load_weights({k: torch.tensor(v) for k, v in weights.items()})
    loras = list(control.layers(LoraAdapter, recurse=True))
    assert len(loras) == n_eligible
    assert not list(sd.unet.layer("DownBlocks", fl.Chain).layers(LoraAdapter, recurse=True))  # the UNet's own path
    want_state = {k: np.asarray(v) for k, v in jax_adapter.control_lora.state_dict().items()}
    layouts = _weight_layouts(control)
    got_state = control.state_dict()
    assert list(got_state) == list(want_state)
    for key, value in want_state.items():
        want_value = value.transpose(layouts[key]) if key in layouts else value
        np.testing.assert_array_equal(got_state[key].numpy(), want_value, err_msg=key)
    condition = inputs["condition"]
    jax_adapter.set_condition(jnp.asarray(condition))
    adapter.set_condition(torch.tensor(nhwc_to_nchw(condition)))
    got, want = _predict(jax_sd, sd, inputs)
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3
    adapter.scale = 0.0
    assert adapter.scale == 0.0 and {z.scale for z in control.layers(control_lora.ZeroConvolution, recurse=True)} == {0.0}
    np.testing.assert_allclose(_port_predict(sd, inputs), bare, rtol=0, atol=1e-5)  # the half-UNet adds zeros
    adapter.scale = 0.8
    with pytest.raises(RuntimeError, match="cannot be copied"):
        adapter.structural_copy()
    jax_adapter.eject()
    adapter.eject()
    assert sd.unet.parent is None and not any(isinstance(m, control_lora.ControlLora) for m in sd.unet)
    assert list(sd.unet.state_dict()) == list(jax_sd.unet.state_dict())
    np.testing.assert_array_equal(_port_predict(sd, inputs), bare)


def test_control_lora_sort_original_keys_matches_jax() -> None:
    """The order in which an original checkpoint's LoRA keys meet the layers."""
    keys = ["input_blocks.4.1.proj_out", "input_blocks.4.1.transformer_blocks.0.attn1.to_q", "time_embed.0",
            "label_emb.0.2", "input_blocks.4.1.transformer_blocks.1.attn1.to_k", "input_blocks.4.1.proj_in",
            "middle_block.1.transformer_blocks.0.ff.net.2", "input_blocks.10.0.in_layers.2", "input_blocks.2.0.out_layers.3"]  # fmt: skip
    want = sorted(keys, key=jax_xl.ControlLoraAdapter.sort_original_keys)
    assert sorted(keys, key=xl.ControlLoraAdapter.sort_original_keys) == want
    assert want[:2] == ["time_embed.0", "label_emb.0.2"]
    assert want.index("input_blocks.4.1.proj_out") > want.index("input_blocks.4.1.transformer_blocks.1.attn1.to_k")


def test_control_lora_copy_keeps_its_own_timestep_key(models: tuple[Any, xl.StableDiffusion_XL]) -> None:
    """The half-UNet writes and reads its timestep embedding under its own
    key; the UNet's encoder and adapters keep theirs; its skips go through
    zero convolutions (the middle block's to residual 9)."""
    _, sd = models
    adapter = xl.ControlLoraAdapter(name="depth", target=sd.unet)
    control = adapter.control_lora
    key = "timestep_embedding_control_lora_depth"
    assert control.layer("TimestepEncoder", fl.Chain).context_key == key  # type: ignore[attr-defined]
    from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeAdapter2d

    assert {r.context_key for r in control.layers(RangeAdapter2d, recurse=True)} == {key}
    assert {r.context_key for r in sd.unet.layers(RangeAdapter2d, recurse=True)} == {"timestep_embedding"}
    assert sd.unet.layer("TimestepEncoder", fl.Chain).context_key == "timestep_embedding"  # type: ignore[attr-defined]
    zero = [z.ensure_find(ResidualAccumulator).n for z in control.layers(control_lora.ZeroConvolution, recurse=True)]
    assert zero == list(range(10))
    assert adapter.init_context() == {"control_lora_depth": {"condition": None}}


# -- full width, on the meta device ----------------------------------------------


def _jax_zoo(base_channels: int = 320, plus: bool = True) -> dict[str, dict[str, Any]]:
    """The JAX package's UNet with every adapter of the zoo injected, and the
    adapters' own modules (with `plus`, IP-Adapter plus's projection, on the
    reduced image encoder: it converts the encoder to grid features); then
    the UNet ejected bare."""
    unet = JaxSDXLUNet(in_channels=4, base_channels=base_channels)
    jax_encoder, _ = _stand_in_encoders()
    control = jax_xl.ControlLoraAdapter(name="tile", target=unet).inject()  # first: the others cannot be copied
    sag = jax_xl.SDXLSAGAdapter(unet).inject()
    t2i = jax_xl.SDXLT2IAdapter(unet, name="canny").inject()
    ip = jax_xl.SDXLIPAdapter(unet, clip_image_encoder=jax_encoder).inject()
    lcm_adapter = jax_xl.SDXLLcmAdapter(unet).inject()
    out = {"unet": unet.state_dict(), "t2i": t2i.condition_encoder.state_dict(), "ip": ip.image_proj.state_dict(),
           "control": control.control_lora.state_dict()}  # fmt: skip
    if plus:
        out["plus"] = jax_xl.SDXLIPAdapter(unet, clip_image_encoder=JaxCLIPImageEncoder(**ENCODER),
                                           fine_grained=True).image_proj.state_dict()  # fmt: skip
    for adapter in (lcm_adapter, ip, t2i, sag, control):
        adapter.eject()
    out["bare"] = unet.state_dict()
    return out


def _check_zoo(want: dict[str, dict[str, Any]], base_channels: int, device: str) -> None:
    """The port's UNet with SAG, a T2I-Adapter, an IP-Adapter, the LCM adapter
    and a Control-LoRA injected together (and IP-Adapter plus's projection):
    every state dict's keys, and shapes in the port's layout, equal `want`;
    the adapters' modules land on the UNet's device; ejecting all leaves the
    UNet's keys."""
    unet = xl.SDXLUNet(in_channels=4, base_channels=base_channels, device=device)
    bare = list(unet.state_dict())
    _, encoder = _stand_in_encoders()
    control = xl.ControlLoraAdapter(name="tile", target=unet).inject()
    sag = xl.SDXLSAGAdapter(unet).inject()
    t2i = xl.SDXLT2IAdapter(unet, name="canny").inject()
    ip = xl.SDXLIPAdapter(unet, clip_image_encoder=encoder).inject()
    lcm_adapter = xl.SDXLLcmAdapter(unet).inject()
    modules = {"unet": unet, "t2i": t2i.condition_encoder, "ip": ip.image_proj, "control": control.control_lora}
    if "plus" in want:
        grid_encoder = CLIPImageEncoder(**ENCODER, device=device)
        modules["plus"] = xl.SDXLIPAdapter(unet, clip_image_encoder=grid_encoder, fine_grained=True).image_proj
        assert modules["plus"].layer(("Linear_1",), fl.Linear).out_features == 1280
    for name, module in modules.items():
        assert module.device == torch.device(device), name
        got, layouts = module.state_dict(), _weight_layouts(module)
        assert sorted(got) == sorted(want[name]), name  # `jax.eval_shape` returns its dicts sorted
        for key, value in want[name].items():
            shape = tuple(value.shape[i] for i in layouts[key]) if key in layouts else tuple(value.shape)
            assert tuple(got[key].shape) == shape, (name, key)
    for adapter in (lcm_adapter, ip, t2i, sag, control):
        adapter.eject()
    assert list(unet.state_dict()) == bare and sorted(bare) == sorted(want["bare"])


def test_adapters_keys_match_jax_reduced() -> None:
    """`_check_zoo` on the reduced UNet (the same keys as at full width) against JAX's, built on the CPU."""
    jax_manual_seed(25)
    _check_zoo(_jax_zoo(base_channels=32, plus=False), base_channels=32, device="cpu")


@pytest.mark.slow
def test_full_width_adapters_on_meta() -> None:
    """`_check_zoo` at full width on `SDXLUNet(device="meta")` against
    `jax.eval_shape` of the JAX package's (no memory on either side; about
    a minute of tracing in JAX)."""
    _check_zoo(jax.eval_shape(_jax_zoo), base_channels=320, device="meta")
