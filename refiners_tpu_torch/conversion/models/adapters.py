"""Upstream key maps for IP-Adapter, T2I-Adapter, HQ-SAM and preprocessors;
counterpart of ``refiners_tpu/conversion/models/adapters.py``.

The reference refiners' tables are ``conversion/models/ipadapter_sd15.py``,
``ipadapter_sdxl.py``, ``t2iadapter_sd15.py`` (SDXL's is identical),
``hq_sam.py`` and ``preprocessors.py``.
"""

from __future__ import annotations

# -- IP-Adapter ---------------------------------------------------------------


def _ip_cross_attention_order(num_down: int, num_mid: int, num_up: int) -> list[int]:
    """The Tencent checkpoints store per-attention K/V projections under odd
    indices in diffusers UNet traversal order (down, up, mid LAST); the
    reference walks down, MID, up. Returns the source odd index for each
    target position."""
    down = [2 * k + 1 for k in range(num_down)]
    up = [2 * (num_down + k) + 1 for k in range(num_up)]
    mid = [2 * (num_down + num_up + k) + 1 for k in range(num_mid)]
    return down + mid + up


def _ip_adapter_keys(num_down: int, num_mid: int, num_up: int) -> dict[str, str]:
    m: dict[str, str] = {}
    for tgt, src in enumerate(_ip_cross_attention_order(num_down, num_mid, num_up)):
        m[f"ip_adapter.{src}.to_k_ip"] = f"ip_adapter.{tgt:03d}.to_k_ip"
        m[f"ip_adapter.{src}.to_v_ip"] = f"ip_adapter.{tgt:03d}.to_v_ip"
    return m


def _ip_resampler_keys(num_layers: int = 4) -> dict[str, str]:
    """IP-Adapter-plus perceiver resampler (ipadapter_sd15.py:44)."""
    m = {
        "image_proj.latents": "image_proj.LatentsToken.Parameter.weight",
        "image_proj.proj_in": "image_proj.Linear_1",
        "image_proj.proj_out": "image_proj.Linear_2",
        "image_proj.norm_out": "image_proj.LayerNorm",
    }
    for n in range(num_layers):
        d = f"image_proj.Transformer.TransformerLayer_{n + 1}"
        m |= {
            f"image_proj.layers.{n}.0.norm1": f"{d}.Residual_1.PerceiverAttention.Distribute.LayerNorm_1",
            f"image_proj.layers.{n}.0.norm2": f"{d}.Residual_1.PerceiverAttention.Distribute.LayerNorm_2",
            f"image_proj.layers.{n}.0.to_q": f"{d}.Residual_1.PerceiverAttention.Parallel.Chain_2.Linear",
            f"image_proj.layers.{n}.0.to_kv": f"{d}.Residual_1.PerceiverAttention.Parallel.Chain_1.Linear",
            f"image_proj.layers.{n}.0.to_out": f"{d}.Residual_1.PerceiverAttention.Linear",
            f"image_proj.layers.{n}.1.0": f"{d}.Residual_2.LayerNorm",
            f"image_proj.layers.{n}.1.1": f"{d}.Residual_2.FeedForward.Linear_1",
            f"image_proj.layers.{n}.1.3": f"{d}.Residual_2.FeedForward.Linear_2",
        }
    return m


def ipadapter_sd15_key_map() -> dict[str, str]:
    return {
        "image_proj.proj": "image_proj.Linear",
        "image_proj.norm": "image_proj.LayerNorm",
    } | _ip_adapter_keys(num_down=6, num_mid=1, num_up=9)


def ipadapter_sd15_plus_key_map() -> dict[str, str]:
    return _ip_resampler_keys() | _ip_adapter_keys(num_down=6, num_mid=1, num_up=9)


def ipadapter_sdxl_key_map() -> dict[str, str]:
    return {
        "image_proj.proj": "image_proj.Linear",
        "image_proj.norm": "image_proj.LayerNorm",
    } | _ip_adapter_keys(num_down=24, num_mid=10, num_up=36)


def ipadapter_sdxl_plus_key_map() -> dict[str, str]:
    return _ip_resampler_keys() | _ip_adapter_keys(num_down=24, num_mid=10, num_up=36)


def ipadapter_plus_reshapes(num_tokens: int = 16, width: int = 768) -> dict[str, tuple[int, ...]]:
    return {"image_proj.LatentsToken.Parameter.weight": (num_tokens, width)}


# -- T2I-Adapter (identical table for SD1.5 and SDXL) -------------------------


def t2iadapter_key_map() -> dict[str, str]:
    m = {"adapter.conv_in": "Conv2d"}
    for i in range(4):
        d = f"StatefulResidualBlocks_{i + 1}.ResidualBlocks"
        if i in (1, 2):
            m[f"adapter.body.{i}.in_conv"] = f"{d}.Conv2d"
        for j in range(2):
            m[f"adapter.body.{i}.resnets.{j}.block1"] = f"{d}.Chain.ResidualBlock_{j + 1}.Conv2d_1"
            m[f"adapter.body.{i}.resnets.{j}.block2"] = f"{d}.Chain.ResidualBlock_{j + 1}.Conv2d_2"
    return m


# -- HQ-SAM -------------------------------------------------------------------


def hq_sam_key_map() -> dict[str, str]:
    hq = "Chain.HQSAMMaskPrediction.Chain.DenseEmbeddingUpscalingHQ"
    m: dict[str, str] = {"mask_decoder.hf_token": "MaskDecoderTokensExtender.hq_token"}
    for src, dst, kinds in [
        ("compress_vit_feat", f"{hq}.HQFeatures.CompressViTFeat", ("ConvTranspose2d_1", "LayerNorm2d", "ConvTranspose2d_2")),
        ("embedding_encoder", f"{hq}.HQFeatures.EmbeddingEncoder", ("ConvTranspose2d_1", "LayerNorm2d", "ConvTranspose2d_2")),
        ("embedding_maskfeature", f"{hq}.EmbeddingMaskfeature", ("Conv2d_1", "LayerNorm2d", "Conv2d_2")),
    ]:
        for idx, kind in zip((0, 1, 3), kinds):
            m[f"mask_decoder.{src}.{idx}"] = f"{dst}.{kind}"
    for n in range(3):
        m[f"mask_decoder.hf_mlp.layers.{n}"] = f"Chain.HQSAMMaskPrediction.HQTokenMLP.MultiLinear.Linear_{n + 1}"
    return m


# -- Preprocessors ------------------------------------------------------------


def informative_drawings_key_map() -> dict[str, str]:
    m = {
        "model0.1": "Chain_1.Conv2d",
        "model1.0": "Chain_2.Conv2d",
        "model1.3": "Chain_3.Conv2d",
        "model3.0": "Chain_4.ConvTranspose2d",
        "model3.3": "Chain_5.ConvTranspose2d",
        "model4.1": "Chain_6.Conv2d",
    }
    for r in range(3):
        m[f"model2.{r}.conv_block.1"] = f"Residual_{r + 1}.Conv2d_1"
        m[f"model2.{r}.conv_block.5"] = f"Residual_{r + 1}.Conv2d_2"
    return m
