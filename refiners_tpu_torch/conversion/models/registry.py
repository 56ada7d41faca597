"""Model weight registry: hub entries + converters per model family;
counterpart of ``refiners_tpu/conversion/models/registry.py``.

The reference refiners publishes its converted checkpoints on the HF hub
("refiners/…" repos, safetensors, refiners key layout). The port's chains
reproduce that layout in torch's tensor layouts, so a hub checkpoint only
needs its keys and shapes checked against the target
(`convert_refiners_state_dict`); each entry builds its target on ``meta``,
which holds no memory. Upstream-format sources (transformers, diffusers,
original repos) convert through `upstream_recipes` / `upstream_converters`.

Converted files land in ``Hub.cache_dir() / "converted_torch"``: the JAX
package writes its own layouts to ``converted/`` under the same cache, and
the two must never read each other's files. Downloads, in the upstream's
layout, are shared.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from refiners_tpu_torch.conversion.utils import Hub


@dataclass
class ModelEntry:
    name: str
    source: Hub
    build_target: Callable[[], Any]
    description: str = ""

    @property
    def converted_path(self) -> Path:
        """Where `convert` writes by default."""
        return Hub.cache_dir() / "converted_torch" / f"{self.name}.safetensors"

    def convert(self, output_path: Path | str | None = None) -> Path:
        """Download (or locate) the refiners-layout checkpoint, check it
        against the target's keys and shapes, and save a ready-to-load
        safetensors file. A key the target lacks, or one of the target's
        that the file lacks, raises KeyError: the port transposes nothing,
        so a refiners-layout file matches its target exactly."""
        from refiners_tpu_torch.conversion.refiners_compat import convert_refiners_state_dict
        from refiners_tpu_torch.fluxion.utils import load_from_safetensors, save_to_safetensors

        src = self.source.download()
        target = self.build_target()
        converted = convert_refiners_state_dict(load_from_safetensors(src), target, strict=True)
        out = Path(output_path) if output_path else self.converted_path
        out.parent.mkdir(parents=True, exist_ok=True)
        save_to_safetensors(out, converted)
        return out


def _sd15_unet() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1UNet

    return SD1UNet(in_channels=4, device="meta")


def _sd15_unet_inpainting() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1UNet

    return SD1UNet(in_channels=9, device="meta")


def _sd15_autoencoder() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1Autoencoder

    return SD1Autoencoder(device="meta")


def _sd15_text_encoder() -> Any:
    from refiners_tpu_torch.foundationals.clip import CLIPTextEncoderL

    return CLIPTextEncoderL(device="meta")


def _sdxl_unet() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SDXLUNet

    return SDXLUNet(in_channels=4, device="meta")


def _sdxl_autoencoder() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SDXLAutoencoder

    return SDXLAutoencoder(device="meta")


def _sdxl_text_encoder() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import DoubleTextEncoder

    return DoubleTextEncoder(device="meta")


def _clip_image_encoder_h() -> Any:
    from refiners_tpu_torch.foundationals.clip import CLIPImageEncoderH

    return CLIPImageEncoderH(device="meta")


def _sam_h() -> Any:
    from refiners_tpu_torch.foundationals.segment_anything import SegmentAnythingH

    return SegmentAnythingH(device="meta")


def _dinov2(variant: str) -> Callable[[], Any]:
    def build() -> Any:
        import refiners_tpu_torch.foundationals.dinov2 as d

        return getattr(d, variant)(device="meta")

    return build


def _mvanet() -> Any:
    from refiners_tpu_torch.foundationals.swin.mvanet import MVANet

    return MVANet(device="meta")


def _controlnet_sd15() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import Controlnet

    return Controlnet(name="converted", device="meta")


def _informative_drawings() -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion.preprocessors import InformativeDrawings

    return InformativeDrawings(device="meta")


def upstream_recipes() -> dict[str, Any]:
    """Upstream-format (diffusers/transformers/original-LDM) `KeyMapRecipe`s,
    keyed by ``<model>/<format>``.

    Mirrors the reference refiners' per-model recipe modules
    (``conversion/models/``); the tables are generated from the
    architecture's structure, the same as the JAX package's.
    """
    from refiners_tpu_torch.conversion.models import adapters, autoencoder, clip_maps, controlnet, diffusion_unet
    from refiners_tpu_torch.conversion.utils import KeyMapRecipe

    return {
        "sd15.unet/diffusers": KeyMapRecipe(key_map=diffusion_unet.sd15_unet_diffusers_key_map()),
        "sd15.unet/civitai": KeyMapRecipe(
            key_map=diffusion_unet.sd15_unet_civitai_key_map(), key_prefix="model.diffusion_model."
        ),
        "sdxl.unet/diffusers": KeyMapRecipe(key_map=diffusion_unet.sdxl_unet_diffusers_key_map()),
        "sdxl.unet/civitai": KeyMapRecipe(
            key_map=diffusion_unet.sdxl_unet_civitai_key_map(), key_prefix="model.diffusion_model."
        ),
        "autoencoder/diffusers": KeyMapRecipe(
            key_map=autoencoder.autoencoder_diffusers_key_map(),
            key_aliases=autoencoder.autoencoder_diffusers_key_aliases(),
        ),
        "autoencoder/civitai": KeyMapRecipe(
            key_map=autoencoder.autoencoder_civitai_key_map(),
            key_prefix="first_stage_model.",
            tensor_reshapes=autoencoder.autoencoder_attention_reshapes(),
        ),
        "controlnet.sd15/diffusers": KeyMapRecipe(key_map=controlnet.controlnet_sd15_diffusers_key_map()),
        "clip_text/transformers": KeyMapRecipe(key_map=clip_maps.clip_text_diffusers_key_map()),
        "clip_text/civitai": KeyMapRecipe(
            key_map=clip_maps.clip_text_civitai_key_map(),
            key_prefix="cond_stage_model.transformer.text_model.",
        ),
        "clip_image/transformers": KeyMapRecipe(
            key_map=clip_maps.clip_image_diffusers_key_map(),
            tensor_reshapes=clip_maps.clip_image_reshapes(),
        ),
        # the SD2.1-unclip CLIP-image encoder: the same generated table
        "clip_image.sd21_unclip/transformers": KeyMapRecipe(
            key_map=clip_maps.clip_image_diffusers_key_map(),
            tensor_reshapes=clip_maps.clip_image_reshapes(),
        ),
        "ipadapter.sd15/tencent": KeyMapRecipe(key_map=adapters.ipadapter_sd15_key_map()),
        "ipadapter.sd15_plus/tencent": KeyMapRecipe(
            key_map=adapters.ipadapter_sd15_plus_key_map(),
            tensor_reshapes=adapters.ipadapter_plus_reshapes(16, 768),
        ),
        "ipadapter.sdxl/tencent": KeyMapRecipe(key_map=adapters.ipadapter_sdxl_key_map()),
        "ipadapter.sdxl_plus/tencent": KeyMapRecipe(
            key_map=adapters.ipadapter_sdxl_plus_key_map(),
            tensor_reshapes=adapters.ipadapter_plus_reshapes(16, 1280),
        ),
        "t2iadapter/tencent": KeyMapRecipe(key_map=adapters.t2iadapter_key_map()),
        "hq_sam/sysu": KeyMapRecipe(key_map=adapters.hq_sam_key_map()),
        "preprocessor.informative_drawings/carolineec": KeyMapRecipe(
            key_map=adapters.informative_drawings_key_map()
        ),
    }


def upstream_converters() -> dict[str, Callable[[dict[str, Any]], dict[str, Any]]]:
    """Programmatic upstream converters (value transforms beyond key renames),
    keyed like `upstream_recipes`; `refiners_compat.convert_refiners_state_dict`
    checks their results against a target."""
    from refiners_tpu_torch.conversion.models import control_lora_sdxl, foundationals

    return {
        "dinov2/facebook": foundationals.convert_dinov2_facebook,
        "ella/tencent": foundationals.convert_ella_tencent,
        "mvanet/official": foundationals.convert_mvanet_official,
        "controllora.sdxl/original": control_lora_sdxl.convert_controllora_sdxl,
    }


def lora_hub() -> dict[str, Hub]:
    """Published LoRA checkpoints (download-only, runtime-loaded)."""
    from refiners_tpu_torch.conversion.models.loras import ALL_LORAS

    return dict(ALL_LORAS)


def control_lora_hub() -> dict[str, Hub]:
    """Original + converted control-lora checkpoints."""
    from refiners_tpu_torch.conversion.models import control_lora_sdxl as m

    return {
        "controllora.sdxl.canny/original": m.canny_original,
        "controllora.sdxl.canny": m.canny_converted,
        "controllora.sdxl.cpds/original": m.cpds_original,
        "controllora.sdxl.cpds": m.cpds_converted,
    }


REGISTRY: dict[str, ModelEntry] = {
    entry.name: entry
    for entry in [
        ModelEntry(
            "sd15.unet",
            Hub("refiners/sd15.unet", "model.safetensors"),
            _sd15_unet,
            "Stable Diffusion 1.5 UNet",
        ),
        ModelEntry(
            "sd15.unet_inpainting",
            Hub("refiners/sd15.unet_inpainting", "model.safetensors"),
            _sd15_unet_inpainting,
            "SD1.5 9-channel inpainting UNet",
        ),
        ModelEntry(
            "sd15.autoencoder",
            Hub("refiners/sd15.autoencoder", "model.safetensors"),
            _sd15_autoencoder,
            "SD1.5 VAE",
        ),
        ModelEntry(
            "sd15.text_encoder",
            Hub("refiners/sd15.text_encoder", "model.safetensors"),
            _sd15_text_encoder,
            "CLIP-L text encoder",
        ),
        ModelEntry(
            "sdxl.unet",
            Hub("refiners/sdxl.unet", "model.safetensors"),
            _sdxl_unet,
            "SDXL UNet",
        ),
        ModelEntry(
            "sdxl.autoencoder",
            Hub("refiners/sdxl.autoencoder", "model.safetensors"),
            _sdxl_autoencoder,
            "SDXL VAE (fp16-fix)",
        ),
        ModelEntry(
            "sdxl.text_encoder",
            Hub("refiners/sdxl.text_encoder", "model.safetensors"),
            _sdxl_text_encoder,
            "SDXL double text encoder",
        ),
        ModelEntry(
            "clip.image_encoder_h",
            Hub("refiners/clip.image_encoder_h", "model.safetensors"),
            _clip_image_encoder_h,
            "CLIP ViT-H image encoder (IP-Adapter)",
        ),
        ModelEntry(
            "sd21.unclip.image_encoder",
            Hub(
                "refiners/sd21.unclip.image_encoder",
                "model.safetensors",
                expected_sha256="c9f43e359e06f1a237324c4c11734d6acd7fbddbfd3b1ed4f1b525267bedb812",
            ),
            _clip_image_encoder_h,
            "SD2.1-unclip CLIP-image encoder (ViT-H)",
        ),
        ModelEntry(
            "sam.vit_h",
            Hub("refiners/sam.vit_h", "model.safetensors"),
            _sam_h,
            "Segment Anything ViT-H",
        ),
        ModelEntry(
            "controlnet.sd15.tile",
            Hub("refiners/controlnet.sd15.tile", "model.safetensors"),
            _controlnet_sd15,
            "SD1.5 ControlNet (tile)",
        ),
        ModelEntry(
            "preprocessor.informative_drawings",
            Hub("refiners/preprocessor.informative_drawings", "model.safetensors"),
            _informative_drawings,
            "Lineart preprocessor",
        ),
        ModelEntry(
            "mvanet",
            Hub("finegrain/finegrain-box-segmenter", "model.safetensors", revision="v0.1"),
            _mvanet,
            "MVANet (box segmenter)",
        ),
        *[
            ModelEntry(
                f"dinov2.{v}",
                Hub(f"refiners/dinov2.{v}", "model.safetensors"),
                _dinov2(f"DINOv2_{v}"),
                f"DINOv2 {v}",
            )
            for v in ["small", "base", "large", "giant", "small_reg", "base_reg", "large_reg", "giant_reg"]
        ],
    ]
}
