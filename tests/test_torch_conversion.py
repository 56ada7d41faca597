"""The port's weight conversion (`refiners_tpu_torch.conversion`) against the
JAX package's, on the CPU.

Both packages emit torch layouts from the key tables, the upstream recipes'
`translate`, the four upstream converters and the CLI's ``--from-file``, so
those outputs are compared directly, bit for bit. The JAX package then
transposes into its own layouts (`convert_refiners_state_dict`,
`KeyMapRecipe.convert`, `ModelEntry.convert`, `ModelConverter`, the CLIP
text recipe): there its output goes through `load_jax_state_dict` into a
port module and is compared with the port's own, tensor by tensor.

Upstream checkpoints are synthesized from a seed: no real file is read. The
full-width models are built on ``meta`` (keys and shapes, no memory). The
JAX package's Control-LoRA converter builds a full-width JAX SDXL UNet and
attaches its LoRAs with a quadratic walk (minutes): its comparison is
``-m slow``; the fast case holds the port's converted dict, loaded in the
refiners layout, against the original-format loader.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Any, Callable

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as load_numpy
from safetensors.numpy import save_file as save_numpy

import refiners_tpu.conversion.cli as jax_cli
import refiners_tpu.conversion.models.registry as jax_registry
import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.conversion.cli as cli
import refiners_tpu_torch.conversion.models.registry as registry
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.conversion import model_converter as jax_model_converter
from refiners_tpu.conversion import refiners_compat as jax_compat
from refiners_tpu.conversion import utils as jax_utils
from refiners_tpu.conversion.models import adapters as jax_adapters
from refiners_tpu.conversion.models import autoencoder as jax_autoencoder
from refiners_tpu.conversion.models import clip_maps as jax_clip_maps
from refiners_tpu.conversion.models import clip_text as jax_clip_text
from refiners_tpu.conversion.models import controlnet as jax_controlnet
from refiners_tpu.conversion.models import diffusion_unet as jax_diffusion_unet
from refiners_tpu.conversion.models import foundationals as jax_foundationals
from refiners_tpu.conversion.models import loras as jax_loras
from refiners_tpu.foundationals.latent_diffusion.preprocessors import InformativeDrawings as JaxInformativeDrawings
from refiners_tpu_torch.conversion import load_jax_state_dict, model_converter, refiners_compat, utils
from refiners_tpu_torch.conversion.models import (
    adapters,
    autoencoder,
    clip_maps,
    clip_text,
    control_lora_sdxl,
    controlnet,
    diffusion_unet,
    foundationals,
    loras,
)
from refiners_tpu_torch.foundationals.clip import CLIPImageEncoderH, CLIPTextEncoder, CLIPTextEncoderL
from refiners_tpu_torch.foundationals.dinov2.vit import ViT
from refiners_tpu_torch.foundationals.latent_diffusion import SD1Autoencoder, SD1UNet, SDXLUNet
from refiners_tpu_torch.foundationals.latent_diffusion.preprocessors import InformativeDrawings
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import Controlnet
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import control_lora
from refiners_tpu_torch.foundationals.swin.mvanet import MVANet


def _numpy(state: dict[str, Any]) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_same(got: dict[str, Any], want: dict[str, Any]) -> None:
    """The same keys, and each tensor of the same shape, dtype and bits."""
    assert sorted(got) == sorted(want), (
        f"only in the port: {sorted(set(got) - set(want))[:4]}; only in JAX: {sorted(set(want) - set(got))[:4]}"
    )
    for key, value in want.items():
        a, b = np.asarray(got[key]), np.asarray(value)
        assert a.shape == b.shape and a.dtype == b.dtype, (key, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


def _through_bridge(build: Callable[[], torch.nn.Module], jax_state: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX-layout state dict loaded (strict) into a fresh port module, read back in torch layouts."""
    module = build()
    load_jax_state_dict(module, _numpy(jax_state), strict=True)
    return module.state_dict()


# ---------------------------------------------------------------------------
# the key tables
# ---------------------------------------------------------------------------

TABLES = [
    (diffusion_unet, jax_diffusion_unet, "sd15_unet_diffusers_key_map", ()),
    (diffusion_unet, jax_diffusion_unet, "sd15_unet_civitai_key_map", ()),
    (diffusion_unet, jax_diffusion_unet, "sdxl_unet_diffusers_key_map", ()),
    (diffusion_unet, jax_diffusion_unet, "sdxl_unet_civitai_key_map", ()),
    (autoencoder, jax_autoencoder, "autoencoder_diffusers_key_map", ()),
    (autoencoder, jax_autoencoder, "autoencoder_diffusers_key_aliases", ()),
    (autoencoder, jax_autoencoder, "autoencoder_civitai_key_map", ()),
    (autoencoder, jax_autoencoder, "autoencoder_attention_reshapes", ()),
    (clip_maps, jax_clip_maps, "clip_text_diffusers_key_map", ()),
    (clip_maps, jax_clip_maps, "clip_text_civitai_key_map", ()),
    (clip_maps, jax_clip_maps, "clip_text_diffusers_key_map", (23,)),
    (clip_maps, jax_clip_maps, "clip_image_diffusers_key_map", ()),
    (clip_maps, jax_clip_maps, "clip_image_reshapes", ()),
    (controlnet, jax_controlnet, "controlnet_sd15_diffusers_key_map", ()),
    (adapters, jax_adapters, "ipadapter_sd15_key_map", ()),
    (adapters, jax_adapters, "ipadapter_sd15_plus_key_map", ()),
    (adapters, jax_adapters, "ipadapter_sdxl_key_map", ()),
    (adapters, jax_adapters, "ipadapter_sdxl_plus_key_map", ()),
    (adapters, jax_adapters, "ipadapter_plus_reshapes", (16, 768)),
    (adapters, jax_adapters, "ipadapter_plus_reshapes", (16, 1280)),
    (adapters, jax_adapters, "t2iadapter_key_map", ()),
    (adapters, jax_adapters, "hq_sam_key_map", ()),
    (adapters, jax_adapters, "informative_drawings_key_map", ()),
]


@pytest.mark.parametrize("module,jax_module,name,args", TABLES, ids=[f"{t[2]}{t[3] or ''}" for t in TABLES])
def test_key_table_matches_jax(module: Any, jax_module: Any, name: str, args: tuple[int, ...]) -> None:
    got, want = getattr(module, name)(*args), getattr(jax_module, name)(*args)
    assert got == want and list(got) == list(want)


def _hub_fields(hub: Any) -> dict[str, Any]:
    return {"url": hub.url, **{f.name: getattr(hub, f.name) for f in dataclasses.fields(hub)}}


def test_registry_recipes_and_hubs_match_jax() -> None:
    """REGISTRY's 21 entries (name, description, Hub fields), the 18 upstream
    recipes field for field, the 4 converters' names, the LoRA and
    Control-LoRA hubs."""
    assert list(registry.REGISTRY) == list(jax_registry.REGISTRY) and len(registry.REGISTRY) == 21
    for name, entry in registry.REGISTRY.items():
        want = jax_registry.REGISTRY[name]
        assert (entry.name, entry.description) == (want.name, want.description)
        assert _hub_fields(entry.source) == _hub_fields(want.source)
    recipes, jax_recipes = registry.upstream_recipes(), jax_registry.upstream_recipes()
    assert list(recipes) == list(jax_recipes) and len(recipes) == 18
    for spec, recipe in recipes.items():
        want = jax_recipes[spec]
        for field in ("key_map", "key_prefix", "key_aliases", "tensor_reshapes"):
            assert getattr(recipe, field) == getattr(want, field), (spec, field)
    assert list(registry.upstream_converters()) == list(jax_registry.upstream_converters())
    assert len(registry.upstream_converters()) == 4
    for port_hubs, jax_hubs in ((registry.lora_hub(), jax_registry.lora_hub()),
                                (registry.control_lora_hub(), jax_registry.control_lora_hub()),
                                (loras.ALL_LORAS, jax_loras.ALL_LORAS)):  # fmt: skip
        assert list(port_hubs) == list(jax_hubs)
        assert all(_hub_fields(port_hubs[k]) == _hub_fields(jax_hubs[k]) for k in jax_hubs)


# ---------------------------------------------------------------------------
# the upstream recipes: full-width coverage, and translate against JAX
# ---------------------------------------------------------------------------

# (builder on meta, the upstream shape of a reshaped target tensor)
FULL_WIDTH: dict[str, tuple[Callable[[], torch.nn.Module], Callable[[tuple[int, ...]], tuple[int, ...]]]] = {
    "sd15.unet/diffusers": (lambda: SD1UNet(in_channels=4, device="meta"), lambda s: s),
    "sd15.unet/civitai": (lambda: SD1UNet(in_channels=4, device="meta"), lambda s: s),
    "sdxl.unet/diffusers": (lambda: SDXLUNet(in_channels=4, device="meta"), lambda s: s),
    "sdxl.unet/civitai": (lambda: SDXLUNet(in_channels=4, device="meta"), lambda s: s),
    "autoencoder/diffusers": (lambda: SD1Autoencoder(device="meta"), lambda s: s),
    # LDM's mid-block attention projections are 1×1 convolutions
    "autoencoder/civitai": (lambda: SD1Autoencoder(device="meta"), lambda s: (*s, 1, 1)),
    "clip_text/transformers": (lambda: CLIPTextEncoderL(device="meta"), lambda s: s),
    "clip_text/civitai": (lambda: CLIPTextEncoderL(device="meta"), lambda s: s),
    # transformers' class embedding is flat
    "clip_image/transformers": (lambda: CLIPImageEncoderH(device="meta"), lambda s: s[1:]),
    "controlnet.sd15/diffusers": (lambda: Controlnet(name="converted", device="meta"), lambda s: s),
}
# target keys that an upstream map leaves out (the JAX package's leaves out the same): none
UNCOVERED: dict[str, set[str]] = {spec: set() for spec in FULL_WIDTH}


def _inverse(recipe: Any) -> dict[str, str]:
    return {target: source for source, target in recipe.key_map.items()}


def upstream_from_target(recipe: Any, state: dict[str, Any], reshape: Callable[..., tuple[int, ...]]) -> dict[str, Any]:
    """The upstream checkpoint a recipe reads for a refiners-layout `state`:
    each key renamed through the inverse of the key map (prefix included),
    reshaped tensors given their upstream shape."""
    inverse = _inverse(recipe)
    out: dict[str, Any] = {}
    for key, value in state.items():
        if key in inverse:  # a target stem that names the tensor itself
            source = recipe.key_prefix + inverse[key]
        else:
            stem, leaf = key.rsplit(".", 1)
            source = f"{recipe.key_prefix}{inverse[stem]}.{leaf}"
        out[source] = value.reshape(reshape(tuple(value.shape))) if key in recipe.tensor_reshapes else value
    return out


@pytest.mark.parametrize("spec", list(FULL_WIDTH))
def test_upstream_map_covers_the_full_width_port_model(spec: str) -> None:
    """Every key of the full-width port model (on meta) is the target of the
    upstream map, and an upstream checkpoint of those keys converts with
    strict=True, its shapes checked."""
    build, reshape = FULL_WIDTH[spec]
    recipe = registry.upstream_recipes()[spec]
    model = build()
    state = model.state_dict()
    targets = set(recipe.key_map.values())
    uncovered = {k for k in state if k not in targets and k.rsplit(".", 1)[0] not in targets}
    assert uncovered == UNCOVERED[spec]
    upstream = upstream_from_target(recipe, state, reshape)
    converted = recipe.convert(upstream, model, strict=True)
    assert sorted(converted) == sorted(state)
    # the JAX recipe reads the same keys (zero-strided arrays of the upstream shapes: no memory)
    zeros = {k: np.broadcast_to(np.float32(0), tuple(v.shape)) for k, v in upstream.items()}
    assert jax_registry.upstream_recipes()[spec].translate(zeros).keys() == converted.keys()


def _synthetic_upstream(recipe: Any, seed: int) -> dict[str, np.ndarray]:
    """Small seeded tensors under every source key of a recipe (the full
    size for reshaped ones), the older alias names where the recipe has
    aliases, and a key that no table knows."""
    rs = np.random.RandomState(seed)
    aliases = {canonical: alias for alias, canonical in recipe.key_aliases.items()}
    out: dict[str, np.ndarray] = {}
    for source, target in recipe.key_map.items():
        source = recipe.key_prefix + aliases.get(source, source)
        for leaf in [""] if target.endswith(".weight") else [".weight", ".bias"]:
            reshape = recipe.tensor_reshapes.get(target + leaf)
            if reshape is not None:
                value = rs.randn(int(np.prod(reshape)))  # flat: the recipe reshapes it
            else:
                value = rs.randn(3) if leaf == ".bias" else rs.randn(3, 2)
            out[source + leaf] = value.astype(np.float32)
    out["some.unknown.layer.weight"] = rs.randn(2).astype(np.float32)
    return out


@pytest.mark.parametrize("spec", list(jax_registry.upstream_recipes()))
def test_upstream_recipe_translate_matches_jax(spec: str) -> None:
    jax_recipe = jax_registry.upstream_recipes()[spec]
    upstream = _synthetic_upstream(jax_recipe, seed=len(spec))
    want = jax_recipe.translate(upstream)
    got = registry.upstream_recipes()[spec].translate({k: torch.from_numpy(v) for k, v in upstream.items()})
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _assert_same({k: v.numpy() for k, v in got.items()}, want)
    assert "some.unknown.layer.weight" not in got and len(got) >= len(jax_recipe.key_map)


# ---------------------------------------------------------------------------
# the programmatic converters
# ---------------------------------------------------------------------------


def _dinov2_checkpoint(depth: int, dim: int, glu: bool, registers: bool) -> dict[str, np.ndarray]:
    """facebook/dinov2 keys at 224² (16² patches of 14 + the class token)."""
    rs = np.random.RandomState(0)

    def t(*shape: int) -> np.ndarray:
        return rs.randn(*shape).astype(np.float32)

    sd = {
        "mask_token": t(1, dim),
        "cls_token": t(1, 1, dim),
        "pos_embed": t(1, 257, dim),
        "patch_embed.proj.weight": t(dim, 3, 14, 14),
        "patch_embed.proj.bias": t(dim),
        "norm.weight": t(dim),
        "norm.bias": t(dim),
    }
    if registers:
        sd["register_tokens"] = t(1, 4, dim)
    for i in range(depth):
        b = f"blocks.{i}"
        sd |= {
            f"{b}.norm1.weight": t(dim), f"{b}.norm1.bias": t(dim),
            f"{b}.attn.qkv.weight": t(3 * dim, dim), f"{b}.attn.qkv.bias": t(3 * dim),
            f"{b}.attn.proj.weight": t(dim, dim), f"{b}.attn.proj.bias": t(dim),
            f"{b}.ls1.gamma": t(dim), f"{b}.norm2.weight": t(dim), f"{b}.norm2.bias": t(dim), f"{b}.ls2.gamma": t(dim),
        }  # fmt: skip
        if glu:
            sd |= {f"{b}.mlp.w12.weight": t(8 * dim, dim), f"{b}.mlp.w12.bias": t(8 * dim),
                   f"{b}.mlp.w3.weight": t(dim, 4 * dim), f"{b}.mlp.w3.bias": t(dim)}  # fmt: skip
        else:
            sd |= {f"{b}.mlp.fc1.weight": t(4 * dim, dim), f"{b}.mlp.fc1.bias": t(4 * dim),
                   f"{b}.mlp.fc2.weight": t(dim, 4 * dim), f"{b}.mlp.fc2.bias": t(dim)}  # fmt: skip
    return sd


@pytest.mark.parametrize("glu,registers", [(False, False), (False, True), (True, False), (True, True)])
def test_dinov2_converter_matches_jax(glu: bool, registers: bool) -> None:
    """Bit-equal to JAX's, and the result loads (strict) into the port's ViT of those widths."""
    sd = _dinov2_checkpoint(depth=2, dim=8, glu=glu, registers=registers)
    got = foundationals.convert_dinov2_facebook({k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_same({k: v.numpy() for k, v in got.items()}, jax_foundationals.convert_dinov2_facebook(sd))
    vit = ViT(embedding_dim=8, patch_size=14, image_size=224, num_layers=2, num_heads=2,
              num_registers=4 if registers else 0, activation=fl.GLU(fl.SiLU()) if glu else None)  # fmt: skip
    vit.load_state_dict(got, strict=True)


def test_ella_converter_matches_jax() -> None:
    rs = np.random.RandomState(1)

    def t(*shape: int) -> np.ndarray:
        return rs.randn(*shape).astype(np.float32)

    d = 16
    sd: dict[str, np.ndarray] = {
        "connector.latents": t(8, d),
        "connector.time_embedding.linear_1.weight": t(d, d), "connector.time_embedding.linear_1.bias": t(d),
        "connector.time_embedding.linear_2.weight": t(d, d), "connector.time_embedding.linear_2.bias": t(d),
        "connector.proj_in.weight": t(d, 24), "connector.proj_in.bias": t(d),
        "connector.time_aware_linear.weight": t(d, d), "connector.time_aware_linear.bias": t(d),
    }  # fmt: skip
    for i in range(2):
        b = f"connector.blocks.{i}"
        sd |= {
            f"{b}.attn.in_proj_weight": t(3 * d, d), f"{b}.attn.in_proj_bias": t(3 * d),
            f"{b}.attn.out_proj.weight": t(d, d), f"{b}.attn.out_proj.bias": t(d),
            f"{b}.ln_1.linear.weight": t(2 * d, d), f"{b}.ln_1.linear.bias": t(2 * d),
            f"{b}.ln_2.linear.weight": t(2 * d, d), f"{b}.ln_2.linear.bias": t(2 * d),
            f"{b}.ln_ff.linear.weight": t(2 * d, d), f"{b}.ln_ff.linear.bias": t(2 * d),
            f"{b}.mlp.c_fc.weight": t(4 * d, d), f"{b}.mlp.c_fc.bias": t(4 * d),
            f"{b}.mlp.c_proj.weight": t(d, 4 * d), f"{b}.mlp.c_proj.bias": t(d),
        }  # fmt: skip
    got = foundationals.convert_ella_tencent({k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_same({k: v.numpy() for k, v in got.items()}, jax_foundationals.convert_ella_tencent(sd))


def _mvanet_checkpoint(depths: tuple[int, ...] = (1, 1, 1, 1)) -> dict[str, np.ndarray]:
    """Official MVANet keys: `depths` Swin blocks a stage, the head's pieces,
    and weights the converter drops."""
    rs = np.random.RandomState(2)
    keys = ["backbone.patch_embed.proj.weight", "backbone.patch_embed.norm.weight"]
    for layer, depth in enumerate(depths):
        keys += [f"backbone.layers.{layer}.blocks.{block}.{leaf}" for block in range(depth) for leaf in (
            "norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "attn.relative_position_bias_table",
            "attn.relative_position_index", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")]  # fmt: skip
        if layer < 3:
            keys += [f"backbone.layers.{layer}.downsample.reduction.weight", f"backbone.layers.{layer}.downsample.norm.weight"]
    keys += ["backbone.norm1.weight", "backbone.norm3.weight", "shallow.0.weight"]
    keys += [f"output{n}.{s}.weight" for n in range(1, 6) for s in range(3)]
    keys += [f"conv{n}.{s}.weight" for n in range(1, 5) for s in range(3)]
    keys += [f"multifieldcrossatt.{p}.weight" for p in ("linear1", "linear2", "linear3", "linear4", "norm1", "norm2")]
    keys += [f"multifieldcrossatt.attention.{n}.in_proj_weight" for n in range(5)]
    keys += ["multifieldcrossatt.linear5.weight"]  # dropped
    for blk in range(1, 5):
        keys += [f"dec_blk{blk}.{p}.weight" for p in ("linear1", "linear3", "linear4", "norm1", "norm2", "sal_conv")]
        keys += [f"dec_blk{blk}.attention.{n}.in_proj_weight" for n in range(8)]
    keys += [f"insmask_head.{s}.weight" for s in range(7)]
    keys += [f"{up}.{s}.weight" for up in ("upsample1", "upsample2") for s in range(2)]
    keys += ["output.0.weight", "sideout5.0.weight"]  # the side output is dropped
    return {key: rs.randn(2).astype(np.float32) for key in keys}


@pytest.mark.parametrize("depths", [(1, 1, 1, 1), (2, 2, 18, 2)])
def test_mvanet_converter_matches_jax(depths: tuple[int, ...]) -> None:
    """Bit-equal to JAX's. At full depth every converted key is one of the
    port's `MVANet()` (dead and training-only weights dropped); at depth 1
    the chain names its single block `SwinTransformerBlock`, unnumbered, in
    both packages, where the converter writes `SwinTransformerBlock_1`."""
    sd = _mvanet_checkpoint(depths)
    got = foundationals.convert_mvanet_official({k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_same({k: v.numpy() for k, v in got.items()}, jax_foundationals.convert_mvanet_official(sd))
    if min(depths) > 1:
        own = MVANet(depths=list(depths), device="meta").state_dict()
        assert set(got) <= set(own), sorted(set(got) - set(own))[:4]


# -- Control-LoRA --------------------------------------------------------------

RANK = 2


def _meta_control_lora(name: str) -> control_lora.ControlLoraAdapter:
    """A ControlLoraAdapter on a full-width SDXL UNet on meta, its own layers
    (condition encoder, zero convolutions) materialized on the CPU."""
    adapter = control_lora.ControlLoraAdapter(target=SDXLUNet(in_channels=4, device="meta"), name=name).inject()
    for owned in (control_lora.ConditionEncoder, control_lora.ZeroConvolution):
        for layer in adapter.control_lora.layers(owned, recurse=True):
            layer.to_empty(device="cpu")
    return adapter


def _original_control_lora(control: control_lora.ControlLora, seed: int) -> dict[str, np.ndarray]:
    """A stability-ai-format Control-LoRA shaped from a ControlLora's tree:
    a rank-2 `.down`/`.up` pair for each Linear and Conv2d outside its zero
    convolutions and condition encoder (conv LoRAs down at the layer's
    kernel, up 1×1), `input_hint_block.{2i}`, `zero_convs.{i}.0`, `middle_block_out.0`."""
    rs = np.random.RandomState(seed)

    def t(*shape: int) -> np.ndarray:
        return (rs.randn(*shape) * 0.05).astype(np.float32)

    owned = {id(w) for kind in (control_lora.ConditionEncoder, control_lora.ZeroConvolution)
             for sub in control.layers(kind, recurse=True) for w in sub.layers(fl.WeightedModule, recurse=True)}  # fmt: skip
    layers = [m for m, _ in control.walk(lambda m, _: isinstance(m, (fl.Linear, fl.Conv2d)), recurse=True)
              if id(m) not in owned]  # fmt: skip
    out: dict[str, np.ndarray] = {}
    for n, layer in enumerate(layers):
        if isinstance(layer, fl.Linear):
            out[f"lora.a{n:04d}.down"], out[f"lora.a{n:04d}.up"] = t(RANK, layer.in_features), t(layer.out_features, RANK)
        else:
            kh, kw = layer.weight.shape[2:]
            out[f"lora.a{n:04d}.down"] = t(RANK, layer.in_channels, kh, kw)
            out[f"lora.a{n:04d}.up"] = t(layer.out_channels, RANK, 1, 1)
    for i, conv in enumerate(control.ensure_find(control_lora.ConditionEncoder).layers(fl.Conv2d, recurse=True)):
        out[f"input_hint_block.{2 * i}.weight"], out[f"input_hint_block.{2 * i}.bias"] = t(*conv.weight.shape), t(conv.out_channels)
    zero_convs = [z.ensure_find(fl.Conv2d) for z in control.layers(control_lora.ZeroConvolution, recurse=True)]
    for i, conv in enumerate(zero_convs):
        stem = f"zero_convs.{i}.0" if i < len(zero_convs) - 1 else "middle_block_out.0"
        out[f"{stem}.weight"], out[f"{stem}.bias"] = t(*conv.weight.shape), t(conv.out_channels)
    return out


@pytest.fixture(scope="module")
def control_lora_checkpoint() -> dict[str, np.ndarray]:
    return _original_control_lora(_meta_control_lora("shape").control_lora, seed=31)


def _owned_state(adapter: control_lora.ControlLoraAdapter) -> dict[str, torch.Tensor]:
    """The ControlLora's tensors that are not the UNet's (LoRAs, condition encoder, zero convolutions)."""
    return {k: v for k, v in adapter.control_lora.state_dict().items() if not v.is_meta}


def test_control_lora_converter_loads_as_the_original_format(control_lora_checkpoint: dict[str, np.ndarray]) -> None:
    """The port's converted dict, loaded in the refiners layout
    (`load_weights`), gives the ControlLora that `load_original_weights`
    gives from the original checkpoint: the same keys, every tensor bit-equal."""
    original = {k: torch.from_numpy(v) for k, v in control_lora_checkpoint.items()}
    converted = control_lora_sdxl.convert_controllora_sdxl(original)
    n_loras = sum(1 for k in control_lora_checkpoint if k.endswith(".down"))
    assert sum(1 for k in converted if k.startswith("ControlLora.") and k.endswith(".down")) == n_loras
    direct, from_converted = _meta_control_lora("direct"), _meta_control_lora("converted")
    direct.load_original_weights(original)
    from_converted.load_weights(converted)
    want, got = _owned_state(direct), _owned_state(from_converted)
    assert sorted(got) == sorted(want) and len(want) == len(converted)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.slow
def test_control_lora_converter_matches_jax(control_lora_checkpoint: dict[str, np.ndarray]) -> None:
    """Bit-equal to the JAX package's `convert_controllora_sdxl` (a full-width
    JAX SDXL UNet, its original-format loader: minutes)."""
    from refiners_tpu.conversion.models.control_lora_sdxl import convert_controllora_sdxl as jax_convert

    got = control_lora_sdxl.convert_controllora_sdxl({k: torch.from_numpy(v) for k, v in control_lora_checkpoint.items()})
    _assert_same({k: v.numpy() for k, v in got.items()}, _numpy(jax_convert(control_lora_checkpoint)))


# ---------------------------------------------------------------------------
# refiners layout → a target: convert_refiners_state_dict, KeyMapRecipe.convert, ModelEntry.convert
# ---------------------------------------------------------------------------


def _refiners_state(seed: int) -> dict[str, np.ndarray]:
    """A seeded refiners-layout (torch layouts) state dict for InformativeDrawings."""
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*v.shape).astype(np.float32) for k, v in InformativeDrawings(device="meta").state_dict().items()}


def test_convert_refiners_state_dict_matches_jax_through_the_bridge() -> None:
    state = _refiners_state(40)
    got = refiners_compat.convert_refiners_state_dict(state, InformativeDrawings(device="meta"))
    want = jax_compat.convert_refiners_state_dict(state, JaxInformativeDrawings())
    bridged = _through_bridge(lambda: InformativeDrawings(), want)
    assert sorted(got) == sorted(bridged)
    for key, value in bridged.items():
        assert torch.equal(got[key], value), key
    target = InformativeDrawings()
    refiners_compat.load_reference_state_dict(target, state)
    assert all(torch.equal(target.state_dict()[k], v) for k, v in got.items())


def test_convert_refiners_state_dict_checks_keys_and_shapes() -> None:
    state = _refiners_state(41)
    target = InformativeDrawings(device="meta")
    first = next(iter(state))
    with pytest.raises(KeyError, match="unexpected"):
        refiners_compat.convert_refiners_state_dict({**state, "Chain_9.Conv2d.weight": state[first]}, target)
    with pytest.raises(KeyError, match="missing"):
        refiners_compat.convert_refiners_state_dict({k: v for k, v in state.items() if k != first}, target)
    # a Conv2d weight in the JAX package's HWIO layout: caught here, where a transpose cannot hide it
    hwio = {**state, first: state[first].transpose(2, 3, 1, 0)}
    with pytest.raises(ValueError, match="shape mismatch"):
        refiners_compat.convert_refiners_state_dict(hwio, target)
    partial = refiners_compat.convert_refiners_state_dict({**state, "extra.weight": state[first]}, target, strict=False)
    assert sorted(partial) == sorted(state)


def test_key_map_recipe_convert_matches_jax_through_the_bridge() -> None:
    """The informative-drawings upstream recipe: the port's `convert` on a
    meta target against JAX's on its model."""
    spec = "preprocessor.informative_drawings/carolineec"
    state = _refiners_state(42)
    upstream = upstream_from_target(registry.upstream_recipes()[spec], state, lambda s: s)
    got = registry.upstream_recipes()[spec].convert(upstream, InformativeDrawings(device="meta"))
    want = jax_registry.upstream_recipes()[spec].convert(upstream, JaxInformativeDrawings())
    bridged = _through_bridge(lambda: InformativeDrawings(), want)
    assert sorted(got) == sorted(bridged)
    for key, value in bridged.items():
        assert torch.equal(got[key], value), key


def test_model_entry_convert_matches_jax_and_writes_elsewhere(tmp_path: Path, monkeypatch: pytest.MonkeyPatch,
                                                              capsys: pytest.CaptureFixture[str]) -> None:  # fmt: skip
    """A refiners-layout file at the Hub's local path (no download): each
    package converts it into its own layout, under a path of its own; the
    two files agree through the bridge. The CLI converts a named entry the same way."""
    monkeypatch.setenv("REFINERS_TPU_WEIGHTS", str(tmp_path / "weights"))
    name = "preprocessor.informative_drawings"
    entry, jax_entry = registry.REGISTRY[name], jax_registry.REGISTRY[name]
    assert entry.source.local_path == jax_entry.source.local_path  # downloads are shared
    entry.source.local_path.parent.mkdir(parents=True)
    save_numpy(_refiners_state(43), str(entry.source.local_path))

    out, jax_out = entry.convert(), jax_entry.convert()
    assert out == entry.converted_path == tmp_path / "weights" / "converted_torch" / f"{name}.safetensors"
    assert jax_out == tmp_path / "weights" / "converted" / f"{name}.safetensors" and out != jax_out
    got = load_numpy(str(out))
    bridged = _through_bridge(lambda: InformativeDrawings(), load_numpy(str(jax_out)))
    assert sorted(got) == sorted(bridged)
    for key, value in bridged.items():
        np.testing.assert_array_equal(got[key], value.numpy(), err_msg=key)
    target = InformativeDrawings().load_from_safetensors(out, strict=True)
    assert all(np.array_equal(target.state_dict()[k].numpy(), v) for k, v in got.items())

    assert cli.main([name, "-o", str(tmp_path / "named.safetensors")]) == 0
    assert capsys.readouterr().out.strip().endswith("named.safetensors")
    _assert_same(load_numpy(str(tmp_path / "named.safetensors")), got)
    assert cli.main(["no.such.model"]) == 1


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_model_entry_convert_refuses_a_file_that_does_not_match(fault: str, tmp_path: Path,
                                                                 monkeypatch: pytest.MonkeyPatch) -> None:  # fmt: skip
    """The port's hub entries convert strictly: a key the target lacks, or
    one of the target's that the file lacks, raises and writes nothing. The
    JAX package's entry drops the first and omits the second (ROADMAP Queue 3)."""
    monkeypatch.setenv("REFINERS_TPU_WEIGHTS", str(tmp_path / "weights"))
    name = "preprocessor.informative_drawings"
    entry, jax_entry = registry.REGISTRY[name], jax_registry.REGISTRY[name]
    state = _refiners_state(44)
    first = next(iter(state))
    if fault == "missing":
        state.pop(first)
    else:
        state["Chain_9.Conv2d.weight"] = state[first]
    entry.source.local_path.parent.mkdir(parents=True)
    save_numpy(state, str(entry.source.local_path))
    with pytest.raises(KeyError, match=fault):
        entry.convert()
    assert not entry.converted_path.exists()
    written = load_numpy(str(jax_entry.convert()))
    assert sorted(written) == sorted(k for k in state if k != "Chain_9.Conv2d.weight")


# ---------------------------------------------------------------------------
# ModelConverter
# ---------------------------------------------------------------------------


class SourceNet(torch.nn.Module):
    """The JAX test's toy torch model, with an idiosyncratic structure."""

    def __init__(self) -> None:
        super().__init__()
        self.embed = torch.nn.Embedding(10, 16)
        self.proj_in = torch.nn.Linear(16, 32)
        self.norm = torch.nn.LayerNorm(32)
        self.blocks = torch.nn.ModuleList([torch.nn.Linear(32, 32) for _ in range(3)])
        self.proj_out = torch.nn.Linear(32, 4)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.proj_in(self.embed(ids)))
        for block in self.blocks:
            x = torch.relu(block(x))
        return self.proj_out(x)


class ConvSource(torch.nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.gn = torch.nn.GroupNorm(2, 8)
        self.conv2 = torch.nn.Conv2d(8, 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.nn.functional.silu(self.gn(self.conv1(x))))


def _toy_target(ns: Any) -> Any:
    return ns.Chain(ns.Embedding(10, 16), ns.Linear(16, 32), ns.LayerNorm(32),
                    *(ns.Chain(ns.Linear(32, 32), ns.ReLU()) for _ in range(3)), ns.Linear(32, 4))  # fmt: skip


def _conv_target(ns: Any) -> Any:
    return ns.Chain(ns.Conv2d(3, 8, 3, padding=1), ns.GroupNorm(8, 2), ns.SiLU(), ns.Conv2d(8, 4, 1))


MODELS = {
    # (source, port/JAX target from a layers namespace, source input, JAX input)
    "toy": (SourceNet, _toy_target, lambda: torch.tensor([[1, 2, 3, 4]]), lambda x: x.numpy()),
    "conv": (ConvSource, _conv_target, lambda: torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(3)),
             lambda x: x.numpy().transpose(0, 2, 3, 1)),
}  # fmt: skip


@pytest.mark.parametrize("model", list(MODELS))
def test_model_converter_matches_jax(model: str) -> None:
    """The same mapping as JAX's, bit-equal converted states through the
    bridge, and the outputs within 1e-5 in float32."""
    import jax.numpy as jnp

    make_source, make_target, make_input, to_jax = MODELS[model]
    torch.manual_seed(0)
    source = make_source().eval()
    x = make_input()
    target, jax_target = make_target(fl), make_target(jfl)

    converter = model_converter.ModelConverter(source_model=source, target_model=target, verbose=False)
    jax_converter = jax_model_converter.ModelConverter(source_model=source, target_model=jax_target, verbose=False)
    mapping = converter.map_state_dicts(source_args=(x,))
    assert mapping == jax_converter.map_state_dicts(source_args=(x,), target_args=(jnp.asarray(to_jax(x)),))
    assert converter.stage == model_converter.ConversionStage.SHAPE_AND_LAYERS_MATCH
    got = converter.convert_state_dict()
    bridged = _through_bridge(lambda: make_target(fl), jax_converter.convert_state_dict())
    assert sorted(got) == sorted(bridged)
    for key, value in bridged.items():
        assert torch.equal(got[key], value), key

    assert converter.run(source_args=(x,))
    assert converter.stage == model_converter.ConversionStage.MODELS_OUTPUT_AGREE and bool(converter)
    with torch.no_grad():
        torch.testing.assert_close(target(x), source(x), atol=1e-5, rtol=0)


def test_model_converter_detects_mismatch() -> None:
    source = SourceNet().eval()
    converter = model_converter.ModelConverter(source_model=source, target_model=fl.Chain(fl.Linear(16, 32)), verbose=False)
    assert converter.map_state_dicts(source_args=(torch.tensor([[1, 2, 3]]),), target_args=(torch.ones(1, 3, 16),)) is None
    assert not converter
    # the same layer count with a transposed shape
    wrong = fl.Chain(fl.Embedding(10, 16), fl.Linear(16, 32), fl.LayerNorm(32),
                     *(fl.Chain(fl.Linear(32, 32), fl.ReLU()) for _ in range(3)), fl.Linear(32, 5))  # fmt: skip
    converter = model_converter.ModelConverter(source_model=source, target_model=wrong, verbose=False)
    assert converter.map_state_dicts(source_args=(torch.tensor([[1, 2, 3]]),)) is None
    assert converter.stage == model_converter.ConversionStage.BASIC_LAYERS_MATCH and not converter


# ---------------------------------------------------------------------------
# the CLIP text recipe against transformers
# ---------------------------------------------------------------------------


def test_hf_clip_text_recipe_against_transformers() -> None:
    """A 3-layer `transformers.CLIPTextModel` converted through the recipe:
    the port's encoder within 2e-5 of transformers' output, and the
    converted state equal to JAX's through the bridge."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    config = transformers.CLIPTextConfig(vocab_size=49408, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                         num_attention_heads=4, max_position_embeddings=77, hidden_act="quick_gelu")  # fmt: skip
    hf = transformers.CLIPTextModel(config).eval()

    def build() -> CLIPTextEncoder:
        return CLIPTextEncoder(embedding_dim=64, num_layers=3, num_attention_heads=4, feedforward_dim=128,
                               use_quick_gelu=True)  # fmt: skip

    encoder = build()
    state = hf.state_dict()
    converted = utils.convert_state_dict(state, clip_text.hf_clip_text_recipe())
    encoder.load_state_dict(converted, strict=True)
    want = jax_utils.convert_state_dict({k: v.numpy() for k, v in state.items()}, jax_clip_text.hf_clip_text_recipe())
    bridged = _through_bridge(build, want)
    for key, value in bridged.items():
        assert torch.equal(converted[key], value), key
    # the keys the recipe skips (a projection, position ids) are dropped, not refused
    extras = {"text_projection.weight": torch.ones(64, 64), "text_model.embeddings.position_ids": torch.arange(77)[None]}
    assert utils.convert_state_dict({**state, **extras}, clip_text.hf_clip_text_recipe()).keys() == converted.keys()

    text = "a photo of a cat riding a bicycle"
    ids = encoder[0](text)
    with torch.no_grad():
        expected = hf(input_ids=ids).last_hidden_state
        got = encoder(text)
    torch.testing.assert_close(got, expected, atol=2e-5, rtol=0)
    half = utils.convert_state_dict(state, clip_text.hf_clip_text_recipe(), dtype=torch.float16)
    assert {v.dtype for v in half.values()} == {torch.float16}


def test_weight_recipe_strict_and_rules() -> None:
    recipe = utils.WeightRecipe(rules=[utils.Rule(r"a\.(\d+)\.w", r"A_\1.weight"), utils.Rule(r"skip", lambda m: None)])
    out = recipe.translate({"a.3.w": np.ones(2, dtype=np.float32), "skip": np.zeros(1)})
    assert list(out) == ["A_3.weight"] and isinstance(out["A_3.weight"], torch.Tensor)
    with pytest.raises(KeyError, match="no conversion rule"):
        recipe.translate({"b": np.ones(1)})
    # the JAX package's raises for a key its rule skips (ROADMAP Queue 3); the port drops it
    jax_recipe = jax_utils.WeightRecipe(rules=[jax_utils.Rule(r"skip", lambda m: None)])
    with pytest.raises(KeyError, match="no conversion rule"):
        jax_recipe.translate({"skip": np.zeros(1)})
    assert list(dataclasses.replace(recipe, strict=False).translate({"b": np.ones(1)})) == []
    assert all(op(torch.ones(2, 3)).shape == (2, 3) for op in (utils.op_linear, utils.op_conv, utils.op_conv_transpose))


# ---------------------------------------------------------------------------
# Hub downloads (file:// URLs: no network)
# ---------------------------------------------------------------------------


def test_hub_download_from_a_file_url(tmp_path: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setenv("REFINERS_TPU_WEIGHTS", str(tmp_path / "cache"))
    payload = np.random.RandomState(5).bytes(3000)
    (tmp_path / "upstream.bin").write_bytes(payload)
    sha = hashlib.sha256(payload).hexdigest()
    hub = utils.Hub("org/model", "weights.bin", expected_sha256=sha, download_url=(tmp_path / "upstream.bin").as_uri())
    jax_hub = jax_utils.Hub("org/model", "weights.bin", expected_sha256=sha, download_url=hub.download_url)
    assert hub.local_path == jax_hub.local_path == tmp_path / "cache" / "org" / "model" / "weights.bin"
    assert not hub.exists_locally()
    assert hub.download() == hub.local_path and hub.local_path.read_bytes() == payload and hub.check_sha256()
    assert hub.download() == hub.local_path  # present: no second download
    assert utils.Hub("org/model", "f").url == jax_utils.Hub("org/model", "f").url


def test_hub_download_refuses_a_sha256_mismatch(tmp_path: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setenv("REFINERS_TPU_WEIGHTS", str(tmp_path / "cache"))
    (tmp_path / "upstream.bin").write_bytes(b"not the pinned file")
    hub = utils.Hub("org/model", "weights.bin", expected_sha256="0" * 64, download_url=(tmp_path / "upstream.bin").as_uri())
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        hub.download()
    assert not hub.local_path.exists()
    missing = utils.Hub("org/model", "gone.bin", download_url=(tmp_path / "absent.bin").as_uri())
    with pytest.raises(RuntimeError, match="place the file"):
        missing.download()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_upstream(spec: str) -> dict[str, np.ndarray]:
    if spec == "dinov2/facebook":
        return _dinov2_checkpoint(depth=2, dim=8, glu=True, registers=True)
    if spec == "mvanet/official":
        return _mvanet_checkpoint()
    return _synthetic_upstream(jax_registry.upstream_recipes()[spec], seed=7)


CLI_SPECS = ["autoencoder/civitai", "autoencoder/diffusers", "clip_text/transformers", "clip_image/transformers",
             "sd15.unet/diffusers", "ipadapter.sd15_plus/tencent", "dinov2/facebook", "mvanet/official"]  # fmt: skip


@pytest.mark.parametrize("spec", CLI_SPECS)
def test_cli_from_file_matches_jax(spec: str, tmp_path: Path) -> None:
    """`--from-file`: the port's output file equal to the JAX CLI's, key for
    key and bit for bit (both write torch layouts)."""
    src = tmp_path / "upstream.safetensors"
    save_numpy(_cli_upstream(spec), str(src))
    out, jax_out = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    assert cli.main(["--from-file", str(src), "--format", spec, "--output", str(out)]) == 0
    assert jax_cli.main(["--from-file", str(src), "--format", spec, "--output", str(jax_out)]) == 0
    _assert_same(load_numpy(str(out)), load_numpy(str(jax_out)))
    assert cli.main(["--from-file", str(src), "--format", spec]) == 0  # default: beside the source
    assert (tmp_path / "upstream.converted.safetensors").exists()


def test_cli_refuses_unknown_formats_and_lists_like_jax(tmp_path: Path, capsys: pytest.CaptureFixture[str]) -> None:
    src = tmp_path / "upstream.safetensors"
    save_numpy({"x.weight": np.ones(2, dtype=np.float32)}, str(src))
    assert cli.main(["--from-file", str(src), "--format", "nope/nope"]) == 1
    err = capsys.readouterr().err
    assert "unknown format 'nope/nope'" in err and "sd15.unet/diffusers" in err
    assert cli.main(["--from-file", str(src)]) == 1
    assert "--from-file requires --format" in capsys.readouterr().err
    assert cli.main([]) == 0
    listing = capsys.readouterr().out
    assert jax_cli.main([]) == 0
    assert listing == capsys.readouterr().out
    assert "controllora.sdxl/original" in listing and "loras.sdxl.lcm" in listing


def test_cli_names_the_key_a_known_format_lacks(tmp_path: Path, capsys: pytest.CaptureFixture[str]) -> None:
    """A facebook DINOv2 file without its final norm: the converter's
    KeyError reaches the caller, naming the key; the JAX package's CLI
    reports it as an unknown format (ROADMAP Queue 3)."""
    src = tmp_path / "upstream.safetensors"
    truncated = {k: v for k, v in _cli_upstream("dinov2/facebook").items() if k != "norm.weight"}
    save_numpy(truncated, str(src))
    with pytest.raises(KeyError, match="norm.weight"):
        cli.main(["--from-file", str(src), "--format", "dinov2/facebook", "-o", str(tmp_path / "out.safetensors")])
    assert not (tmp_path / "out.safetensors").exists()
    assert jax_cli.main(["--from-file", str(src), "--format", "dinov2/facebook"]) == 1
    assert "unknown format 'dinov2/facebook'" in capsys.readouterr().err


def test_cli_keeps_a_bf16_checkpoint_in_bf16(tmp_path: Path) -> None:
    """A bf16 upstream file stays bf16 through the port's CLI, as torch
    saves it; the JAX package's CLI writes float32 (its safetensors writer
    goes through numpy, which has no bf16: ROADMAP Queue 3). The values agree."""
    from safetensors.torch import load_file, save_file

    spec = "clip_text/transformers"
    upstream = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _cli_upstream(spec).items()}
    src = tmp_path / "upstream.safetensors"
    save_file(upstream, str(src))
    out, jax_out = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    assert cli.main(["--from-file", str(src), "--format", spec, "--output", str(out)]) == 0
    assert jax_cli.main(["--from-file", str(src), "--format", spec, "--output", str(jax_out)]) == 0
    got, want = load_file(str(out)), load_numpy(str(jax_out))
    assert {v.dtype for v in got.values()} == {torch.bfloat16} and {v.dtype for v in want.values()} == {np.dtype(np.float32)}
    _assert_same({k: v.float().numpy() for k, v in got.items()}, want)
