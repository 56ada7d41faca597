"""The port's image prompts and textual inversion against the JAX package, on the CPU.

`CLIPImageEncoder` at the golden's reduced size (`tests/e2e/golden_cfg.py`,
`build_ip_adapter_plus`: 32² images, 64 wide, patches of 16, 32 layers),
pooled and as grid features; `CLIPImageEncoderH` on the meta device against
the JAX package's shapes (`jax.eval_shape`, no memory); `ImageProjection`,
`PerceiverResampler` and `SD1IPAdapter` (± `fine_grained`) on the reduced
UNet (`SD1UNet(base_channels=32)`); `preprocess_image`; `ConceptExtender` on
a reduced CLIP. Weights are built in JAX from a seed and bridged with
strict=True, or given in the checkpoints' torch layout to both packages.
Float32: 1e-4 relative; `preprocess_image` and the token ids exactly.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.clip import CLIPImageEncoder as JaxCLIPImageEncoder
from refiners_tpu.foundationals.clip import CLIPImageEncoderH as JaxCLIPImageEncoderH
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip import ConceptExtender as JaxConceptExtender
from refiners_tpu.foundationals.latent_diffusion import SD1IPAdapter as JaxSD1IPAdapter
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu.foundationals.latent_diffusion.image_prompt import ImageProjection as JaxImageProjection
from refiners_tpu.foundationals.latent_diffusion.image_prompt import IPAdapter as JaxIPAdapter
from refiners_tpu.foundationals.latent_diffusion.image_prompt import PerceiverResampler as JaxPerceiverResampler
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.conversion.jax_bridge import _weight_layouts
from refiners_tpu_torch.foundationals.clip import CLIPImageEncoder, CLIPImageEncoderH, CLIPTextEncoder, ConceptExtender
from refiners_tpu_torch.foundationals.clip.concepts import EmbeddingExtender, TokenExtender
from refiners_tpu_torch.foundationals.latent_diffusion import SD1IPAdapter, SD1UNet
from refiners_tpu_torch.foundationals.latent_diffusion.image_prompt import (
    CrossAttentionAdapter,
    ImageProjection,
    IPAdapter,
    PerceiverResampler,
)

TOL = 1e-4
VIT_H_PARAMETERS = 632_076_800
# the golden's reduced encoder (golden_cfg.build_ip_adapter_plus)
ENCODER = {"image_size": 32, "embedding_dim": 64, "output_dim": 48, "patch_size": 16, "num_layers": 32,
           "num_attention_heads": 4, "feedforward_dim": 128}  # fmt: skip
CONCEPT = "<test-artwork>"


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


@pytest.fixture(scope="module")
def encoders() -> tuple[Any, CLIPImageEncoder]:
    jax_manual_seed(0)
    jax_encoder, encoder = JaxCLIPImageEncoder(**ENCODER), CLIPImageEncoder(**ENCODER)
    _bridge(encoder, jax_encoder)
    return jax_encoder, encoder


@pytest.fixture(scope="module")
def images() -> np.ndarray:
    return np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("grid", [False, True], ids=["pooled", "grid"])
def test_clip_image_encoder_matches_jax(grid: bool, encoders: tuple[Any, CLIPImageEncoder], images: np.ndarray) -> None:
    """Pooled (B, 48) embeddings, and the penultimate layer's (B, 5, 64)
    grid features (class token and 4 patches) of `convert_to_grid_features`."""
    jax_encoder, encoder = encoders
    if grid:
        jax_encoder, encoder = JaxIPAdapter.convert_to_grid_features(jax_encoder), IPAdapter.convert_to_grid_features(encoder)
        assert len(encoder) == 3 and len(encoder[-1]) == ENCODER["num_layers"] - 1
    want = np.asarray(jax_encoder(jnp.asarray(images)))
    with torch.no_grad():
        got = encoder(torch.tensor(nhwc_to_nchw(images))).numpy()
    assert got.shape == want.shape == ((2, 5, 64) if grid else (2, 48)) and _rel(got, want) <= TOL


def test_clip_image_encoder_h_on_meta() -> None:
    """ViT-H/14's keys, and shapes in the port's layout, against the JAX package's (no memory on either side)."""
    want = jax.eval_shape(lambda: JaxCLIPImageEncoderH().state_dict())
    encoder = CLIPImageEncoderH(device="meta")
    layouts = _weight_layouts(encoder)
    got = encoder.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        shape = tuple(value.shape[i] for i in layouts[key]) if key in layouts else tuple(value.shape)
        assert tuple(got[key].shape) == shape, key
    n = sum(p.numel() for p in encoder.parameters())
    print(f"CLIPImageEncoderH: {n} parameters")
    assert n == VIT_H_PARAMETERS == sum(math.prod(v.shape) for v in want.values())
    assert encoder.layer("ViTEmbeddings.Concatenate.ClassToken.Parameter".split("."), fl.Parameter).weight.shape == (1, 1280)


def test_image_projection_matches_jax() -> None:
    jax_manual_seed(2)
    jax_proj, proj = JaxImageProjection(clip_image_embedding_dim=48), ImageProjection(clip_image_embedding_dim=48)
    _bridge(proj, jax_proj)
    x = np.random.RandomState(3).randn(2, 48).astype(np.float32)
    with torch.no_grad():
        got = proj(torch.tensor(x)).numpy()
    assert got.shape == (2, 4, 768) and _rel(got, np.asarray(jax_proj(jnp.asarray(x)))) <= TOL


def test_perceiver_resampler_matches_jax() -> None:
    """2 layers of perceiver attention (Q and K scaled by d^-¼ each) over
    (B, 5, 64) grid features, 16 learned latents, to (B, 16, 96)."""
    kwargs = {"latents_dim": 64, "num_attention_layers": 2, "num_attention_heads": 4, "head_dim": 16,
              "num_tokens": 16, "input_dim": 64, "output_dim": 96}  # fmt: skip
    jax_manual_seed(4)
    jax_resampler, resampler = JaxPerceiverResampler(**kwargs), PerceiverResampler(**kwargs)
    _bridge(resampler, jax_resampler)
    x = np.random.RandomState(5).randn(2, 5, 64).astype(np.float32)
    with torch.no_grad():
        got = resampler(torch.tensor(x)).numpy()
    assert got.shape == (2, 16, 96) and _rel(got, np.asarray(jax_resampler(jnp.asarray(x)))) <= TOL
    with torch.no_grad():  # the context is reset after each call
        np.testing.assert_array_equal(resampler(torch.tensor(x)).numpy(), got)


@pytest.fixture(scope="module")
def unets() -> tuple[Any, SD1UNet]:
    jax_manual_seed(6)
    jax_unet, unet = JaxSD1UNet(in_channels=4, base_channels=32), SD1UNet(in_channels=4, base_channels=32)
    _bridge(unet, jax_unet)
    return jax_unet, unet


@pytest.fixture(scope="module")
def unet_inputs() -> dict[str, np.ndarray]:
    rs = np.random.RandomState(7)
    return {"x": rs.randn(2, 16, 16, 4).astype(np.float32), "emb": rs.randn(2, 77, 768).astype(np.float32)}


def _jax_unet(unet: Any, inputs: dict[str, np.ndarray], image_embedding: Any) -> np.ndarray:
    """One JAX UNet call under jit (contexts set inside: those set outside do not reach it)."""

    def call(u: Any, x: jax.Array, e: jax.Array, i: jax.Array) -> jax.Array:
        u.set_timestep(jnp.asarray([500]))
        u.set_clip_text_embedding(e)
        u.set_context("ip_adapter", {"clip_image_embedding": i})
        return u(x)

    return np.asarray(jax.jit(call)(unet, jnp.asarray(inputs["x"]), jnp.asarray(inputs["emb"]), image_embedding))


def _port_unet(unet: SD1UNet, inputs: dict[str, np.ndarray]) -> np.ndarray:
    with torch.no_grad():
        unet.set_timestep(torch.tensor([500]))
        unet.set_clip_text_embedding(torch.tensor(inputs["emb"]))
        return nchw_to_nhwc(unet(torch.tensor(nhwc_to_nchw(inputs["x"]))).numpy())


def _checkpoint(fine_grained: bool, unet: SD1UNet, seed: int) -> dict[str, np.ndarray]:
    """An IP-Adapter checkpoint in the torch layout: the projection's weights
    and, for each of the 16 text cross-attentions, its image keys' and
    values' (out, in) projections."""
    rs = np.random.RandomState(seed)
    proj = (PerceiverResampler(latents_dim=768, num_attention_layers=4, num_attention_heads=12, head_dim=64,
                               num_tokens=16, input_dim=64, output_dim=768)
            if fine_grained else ImageProjection(clip_image_embedding_dim=48))  # fmt: skip
    weights = {f"image_proj.{k}": (rs.randn(*v.shape) * (0.05 if v.ndim > 1 else 1.0)).astype(np.float32)
               for k, v in proj.state_dict().items()}  # fmt: skip
    cross_attentions = [a for a in unet.layers(fl.Attention) if type(a) != fl.SelfAttention]
    for i, attention in enumerate(cross_attentions):
        for name in ("to_k_ip", "to_v_ip"):
            weights[f"ip_adapter.{i:03d}.{name}.weight"] = (rs.randn(attention.inner_dim, 768) * 0.05).astype(np.float32)
    return weights


@pytest.mark.parametrize("fine_grained", [False, True], ids=["ip_adapter", "ip_adapter_plus"])
def test_sd1_ip_adapter_matches_jax(
    fine_grained: bool, encoders: tuple[Any, CLIPImageEncoder], images: np.ndarray, unets: tuple[Any, SD1UNet],
    unet_inputs: dict[str, np.ndarray],
) -> None:  # fmt: skip
    """`SD1IPAdapter` on the reduced UNet with the reduced encoder: weights
    from one torch-layout checkpoint (`load_weights` keeps the layout), the
    image embedding (negative ‖ conditional), the UNet's output at scale 1,
    the scale setter (0 gives the bare output), and eject."""
    jax_encoder, encoder = encoders
    jax_unet, unet = unets
    bare = _port_unet(unet, unet_inputs)
    weights = _checkpoint(fine_grained, unet, seed=8)
    adapter = SD1IPAdapter(unet, clip_image_encoder=encoder, fine_grained=fine_grained,
                           weights={k: torch.tensor(v) for k, v in weights.items()}).inject()  # fmt: skip
    proj_state = {k.removeprefix("image_proj."): v for k, v in weights.items() if k.startswith("image_proj.")}
    jax_weights = {f"image_proj.{k}": jnp.asarray(v) for k, v in _to_jax_layout(adapter.image_proj, proj_state).items()}
    jax_weights.update({k: jnp.asarray(v) for k, v in weights.items() if k.startswith("ip_adapter.")})
    jax_adapter = JaxSD1IPAdapter(jax_unet, clip_image_encoder=jax_encoder, fine_grained=fine_grained,
                                  weights=jax_weights).inject()  # fmt: skip
    assert len(adapter.sub_adapters) == 16 and isinstance(adapter.sub_adapters[0], CrossAttentionAdapter)
    key = adapter.sub_adapters[3].image_key_projection.weight
    np.testing.assert_array_equal(key.detach().numpy(), weights["ip_adapter.003.to_k_ip.weight"])
    assert list(unet.state_dict()) == list(jax_unet.state_dict())

    want_embedding = jax_adapter.compute_clip_image_embedding(jnp.asarray(images[:1]))
    with torch.no_grad():
        embedding = adapter.compute_clip_image_embedding(torch.tensor(nhwc_to_nchw(images[:1])))
    tokens = 16 if fine_grained else 4
    assert embedding.shape == (2, tokens, 768) and _rel(embedding.numpy(), np.asarray(want_embedding)) <= TOL
    adapter.set_clip_image_embedding(embedding)
    got = _port_unet(unet, unet_inputs)
    want = _jax_unet(jax_unet, unet_inputs, want_embedding)
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3

    adapter.scale = 0.0
    assert {a.scale for a in adapter.sub_adapters} == {0.0}
    np.testing.assert_array_equal(_port_unet(unet, unet_inputs), bare)
    adapter.scale = 1.0
    jax_adapter.eject()
    adapter.eject()
    assert not list(unet.layers(CrossAttentionAdapter, recurse=True))
    np.testing.assert_array_equal(_port_unet(unet, unet_inputs), bare)


def test_ip_adapter_casts_to_the_unet() -> None:
    """A float32 embedding or image on a bf16 UNet is cast to its dtype; the
    default encoder and projection are built in the UNet's dtype."""
    unet = SD1UNet(in_channels=4, base_channels=32, dtype=torch.bfloat16)
    encoder = CLIPImageEncoder(**ENCODER, dtype=torch.bfloat16)
    adapter = SD1IPAdapter(unet, clip_image_encoder=encoder)
    assert adapter.image_proj.dtype == torch.bfloat16
    with torch.no_grad():
        embedding = adapter.compute_clip_image_embedding(torch.randn(1, 3, 32, 32))
    assert embedding.dtype == torch.bfloat16 and embedding.shape == (2, 4, 768)
    adapter.set_clip_image_embedding(embedding.float())
    assert adapter.use_context("ip_adapter")["clip_image_embedding"].dtype == torch.bfloat16


def test_preprocess_image_matches_jax() -> None:
    """Resize to 224² and CLIP's normalization, bit for bit, on a 300 × 200 image."""
    rs = np.random.RandomState(9)
    image = Image.fromarray((rs.rand(200, 300, 3) * 255).astype(np.uint8))
    jax_manual_seed(10)
    jax_adapter = JaxSD1IPAdapter(JaxSD1UNet(in_channels=4, base_channels=32), clip_image_encoder=JaxCLIPImageEncoder(**ENCODER))
    adapter = SD1IPAdapter(SD1UNet(in_channels=4, base_channels=32), clip_image_encoder=CLIPImageEncoder(**ENCODER))
    got = adapter.preprocess_image(image)
    assert got.shape == (1, 3, 224, 224) and got.dtype == torch.float32
    np.testing.assert_array_equal(nchw_to_nhwc(got.numpy()), np.asarray(jax_adapter.preprocess_image(image)))


# -- textual inversion ----------------------------------------------------------


@pytest.fixture(scope="module")
def text_encoders() -> tuple[Any, CLIPTextEncoder]:
    kwargs = {"embedding_dim": 64, "num_layers": 2, "num_attention_heads": 4, "feedforward_dim": 128}
    jax_manual_seed(11)
    jax_encoder, encoder = JaxCLIPTextEncoder(**kwargs), CLIPTextEncoder(**kwargs)
    _bridge(encoder, jax_encoder)
    return jax_encoder, encoder


def test_concept_extender_matches_jax(text_encoders: tuple[Any, CLIPTextEncoder]) -> None:
    """A concept of the golden's name: the prompt's token ids (the concept
    one id, the last row of the extended table), the table under JAX's keys,
    the text embeddings; eject restores the tokenizer and the table."""
    jax_encoder, encoder = text_encoders
    prompt = f"a cute cat on a {CONCEPT}"
    with torch.no_grad():
        bare = encoder(prompt).numpy()
    concept = np.random.RandomState(12).randn(64).astype(np.float32)
    jax_extender, extender = JaxConceptExtender(jax_encoder), ConceptExtender(encoder)
    jax_extender.add_concept(CONCEPT, jnp.asarray(concept))
    extender.add_concept(CONCEPT, torch.tensor(concept))
    jax_extender.inject()
    extender.inject()
    assert isinstance(encoder[0], TokenExtender) and encoder.find(fl.Sum).find(EmbeddingExtender) is not None

    ids = encoder[0](prompt)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_encoder[0](prompt)))
    assert int(ids[0, 6]) == 49408 and int(ids[0, 7]) == 49407  # the concept, then the end of text
    state = {k: v.detach().numpy() for k, v in encoder.state_dict().items()}
    want_state = jax_encoder.state_dict()
    assert sorted(state) == sorted(want_state)
    assert state["Sum.EmbeddingExtender.new_weight"].shape == (1, 64)
    np.testing.assert_array_equal(state["Sum.EmbeddingExtender.new_weight"][0], concept)
    np.testing.assert_array_equal(state["Sum.EmbeddingExtender.old_weight"], np.asarray(want_state["Sum.EmbeddingExtender.old_weight"]))
    with torch.no_grad():
        got = encoder(prompt).numpy()
    want = np.asarray(jax_encoder(prompt))
    assert _rel(got, want) <= TOL and _rel(got, bare) > 1e-3

    jax_extender.eject()
    extender.eject()
    assert not encoder.find(TokenExtender) and encoder.find(fl.Sum).find(EmbeddingExtender) is None
    with torch.no_grad():
        np.testing.assert_array_equal(encoder(prompt).numpy(), bare)
    outer = ConceptExtender(encoder).inject()
    with pytest.raises(AssertionError, match="cannot be nested"):
        ConceptExtender(encoder)
    outer.eject()
