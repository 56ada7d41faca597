"""Upstream key maps for the SD autoencoder (KL-VAE, shared by SD1.5/SDXL);
counterpart of ``refiners_tpu/conversion/models/autoencoder.py``.

The reference refiners' tables are ``conversion/models/autoencoder_sd15.py``
(diffusers, and original-LDM "civitai"); SDXL reuses them verbatim, since
the architectures are identical.
"""

from __future__ import annotations

_CH = [128, 128, 256, 512, 512]  # per-stage output channels (encoder order)


def _vae_resnet(src: str, dst: str, shortcut: bool, ldm: bool) -> dict[str, str]:
    m = {
        f"{src}.norm1": f"{dst}.Chain.GroupNorm_1",
        f"{src}.conv1": f"{dst}.Chain.Conv2d_1",
        f"{src}.norm2": f"{dst}.Chain.GroupNorm_2",
        f"{src}.conv2": f"{dst}.Chain.Conv2d_2",
    }
    if shortcut:
        m[f"{src}.nin_shortcut" if ldm else f"{src}.conv_shortcut"] = f"{dst}.Conv2d"
    return m


def _vae_mid(src_resnets: list[str], src_attn: str, dst: str, ldm: bool) -> dict[str, str]:
    attn_src = (
        {"q": "q", "k": "k", "v": "v", "out": "proj_out", "norm": "norm"}
        if ldm
        else {"q": "to_q", "k": "to_k", "v": "to_v", "out": "to_out.0", "norm": "group_norm"}
    )
    m = _vae_resnet(src_resnets[0], f"{dst}.Resnet_1", False, ldm)
    m |= {
        f"{src_attn}.{attn_src['norm']}": f"{dst}.Residual.GroupNorm",
        f"{src_attn}.{attn_src['q']}": f"{dst}.Residual.SelfAttention2d.Distribute.Linear_1",
        f"{src_attn}.{attn_src['k']}": f"{dst}.Residual.SelfAttention2d.Distribute.Linear_2",
        f"{src_attn}.{attn_src['v']}": f"{dst}.Residual.SelfAttention2d.Distribute.Linear_3",
        f"{src_attn}.{attn_src['out']}": f"{dst}.Residual.SelfAttention2d.Linear",
    }
    m |= _vae_resnet(src_resnets[1], f"{dst}.Resnet_2", False, ldm)
    return m


def autoencoder_diffusers_key_map() -> dict[str, str]:
    """diffusers AutoencoderKL keys → reference layout (autoencoder_sd15.py:5)."""
    m = {
        "encoder.conv_in": "Encoder.Conv2d",
        "encoder.conv_norm_out": "Encoder.Chain_2.GroupNorm",
        "encoder.conv_out": "Encoder.Chain_2.Conv2d",
        "quant_conv": "Encoder.Chain_3.Conv2d",
        "post_quant_conv": "Decoder.Conv2d_1",
        "decoder.conv_in": "Decoder.Conv2d_2",
        "decoder.conv_norm_out": "Decoder.Chain_2.GroupNorm",
        "decoder.conv_out": "Decoder.Chain_2.Conv2d",
    }
    for i in range(4):  # encoder: 4 down stages, 2 resnets each
        for j in range(2):
            shortcut = j == 0 and i in (1, 2)
            m |= _vae_resnet(
                f"encoder.down_blocks.{i}.resnets.{j}",
                f"Encoder.Chain_1.Chain_{i + 1}.Resnet_{j + 1}",
                shortcut,
                ldm=False,
            )
        if i < 3:
            m[f"encoder.down_blocks.{i}.downsamplers.0.conv"] = f"Encoder.Chain_1.Chain_{i + 1}.Downsample.Conv2d"
    m |= _vae_mid(
        ["encoder.mid_block.resnets.0", "encoder.mid_block.resnets.1"],
        "encoder.mid_block.attentions.0",
        "Encoder.Chain_1.Chain_5",
        ldm=False,
    )
    m |= _vae_mid(
        ["decoder.mid_block.resnets.0", "decoder.mid_block.resnets.1"],
        "decoder.mid_block.attentions.0",
        "Decoder.Chain_1.Chain_1",
        ldm=False,
    )
    for i in range(4):  # decoder: 4 up stages, 3 resnets each
        for j in range(3):
            shortcut = j == 0 and i in (2, 3)
            m |= _vae_resnet(
                f"decoder.up_blocks.{i}.resnets.{j}",
                f"Decoder.Chain_1.Chain_{i + 2}.Resnet_{j + 1}",
                shortcut,
                ldm=False,
            )
        if i < 3:
            m[f"decoder.up_blocks.{i}.upsamplers.0.conv"] = f"Decoder.Chain_1.Chain_{i + 2}.Upsample.Conv2d"
    return m


def autoencoder_diffusers_key_aliases() -> dict[str, str]:
    """Older diffusers attention naming (query/key/value/proj_attn)."""
    out: dict[str, str] = {}
    for part in ("encoder", "decoder"):
        a = f"{part}.mid_block.attentions.0"
        out |= {
            f"{a}.query": f"{a}.to_q",
            f"{a}.key": f"{a}.to_k",
            f"{a}.value": f"{a}.to_v",
            f"{a}.proj_attn": f"{a}.to_out.0",
        }
    return out


def autoencoder_civitai_key_map() -> dict[str, str]:
    """Original-LDM VAE keys ("first_stage_model.") → reference layout
    (autoencoder_sd15.py:144)."""
    m = {
        "encoder.conv_in": "Encoder.Conv2d",
        "encoder.norm_out": "Encoder.Chain_2.GroupNorm",
        "encoder.conv_out": "Encoder.Chain_2.Conv2d",
        "quant_conv": "Encoder.Chain_3.Conv2d",
        "post_quant_conv": "Decoder.Conv2d_1",
        "decoder.conv_in": "Decoder.Conv2d_2",
        "decoder.norm_out": "Decoder.Chain_2.GroupNorm",
        "decoder.conv_out": "Decoder.Chain_2.Conv2d",
    }
    for i in range(4):
        for j in range(2):
            shortcut = j == 0 and i in (1, 2)
            m |= _vae_resnet(
                f"encoder.down.{i}.block.{j}",
                f"Encoder.Chain_1.Chain_{i + 1}.Resnet_{j + 1}",
                shortcut,
                ldm=True,
            )
        if i < 3:
            m[f"encoder.down.{i}.downsample.conv"] = f"Encoder.Chain_1.Chain_{i + 1}.Downsample.Conv2d"
    m |= _vae_mid(
        ["encoder.mid.block_1", "encoder.mid.block_2"], "encoder.mid.attn_1", "Encoder.Chain_1.Chain_5", ldm=True
    )
    m |= _vae_mid(
        ["decoder.mid.block_1", "decoder.mid.block_2"], "decoder.mid.attn_1", "Decoder.Chain_1.Chain_1", ldm=True
    )
    for i in range(4):  # LDM up indices are reversed: up.0 is the shallowest stage
        stage = 5 - i  # up.0 → Chain_5 … up.3 → Chain_2
        for j in range(3):
            shortcut = j == 0 and i in (0, 1)
            m |= _vae_resnet(
                f"decoder.up.{i}.block.{j}",
                f"Decoder.Chain_1.Chain_{stage}.Resnet_{j + 1}",
                shortcut,
                ldm=True,
            )
        if i > 0:
            m[f"decoder.up.{i}.upsample.conv"] = f"Decoder.Chain_1.Chain_{stage}.Upsample.Conv2d"
    return m


def autoencoder_attention_reshapes() -> dict[str, tuple[int, ...]]:
    """LDM stores the mid attention projections as 1x1 convs; flatten to Linear
    (autoencoder_sd15.py:272)."""
    out: dict[str, tuple[int, ...]] = {}
    for dst in ("Encoder.Chain_1.Chain_5", "Decoder.Chain_1.Chain_1"):
        for leaf in (
            "Residual.SelfAttention2d.Distribute.Linear_1",
            "Residual.SelfAttention2d.Distribute.Linear_2",
            "Residual.SelfAttention2d.Distribute.Linear_3",
            "Residual.SelfAttention2d.Linear",
        ):
            out[f"{dst}.{leaf}.weight"] = (512, 512)
    return out
