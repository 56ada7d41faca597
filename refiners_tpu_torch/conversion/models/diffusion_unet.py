"""Upstream-format key maps for the SD1.5 / SDXL UNets; counterpart of
``refiners_tpu/conversion/models/diffusion_unet.py``.

Maps diffusers- and original-LDM ("civitai") checkpoint keys onto the
reference key layout (which the port's chains reproduce), so upstream
checkpoints convert through `KeyMapRecipe`.

The reference refiners ships these as literal ~950/2200-line tables
(``conversion/models/unet_sd15.py``, ``unet_sdxl.py``); here they are
generated from the architecture's structure.
"""

from __future__ import annotations

# -- shared sub-block patterns ------------------------------------------------


def _resnet_diffusers(src: str, dst: str, shortcut: bool) -> dict[str, str]:
    m = {
        f"{src}.norm1": f"{dst}.Chain.GroupNorm_1",
        f"{src}.conv1": f"{dst}.Chain.RangeAdapter2d.Conv2d",
        f"{src}.time_emb_proj": f"{dst}.Chain.RangeAdapter2d.Chain.Linear",
        f"{src}.norm2": f"{dst}.Chain.GroupNorm_2",
        f"{src}.conv2": f"{dst}.Chain.Conv2d",
    }
    if shortcut:
        m[f"{src}.conv_shortcut"] = f"{dst}.Conv2d"
    return m


def _resnet_ldm(src: str, dst: str, shortcut: bool) -> dict[str, str]:
    m = {
        f"{src}.in_layers.0": f"{dst}.Chain.GroupNorm_1",
        f"{src}.in_layers.2": f"{dst}.Chain.RangeAdapter2d.Conv2d",
        f"{src}.emb_layers.1": f"{dst}.Chain.RangeAdapter2d.Chain.Linear",
        f"{src}.out_layers.0": f"{dst}.Chain.GroupNorm_2",
        f"{src}.out_layers.3": f"{dst}.Chain.Conv2d",
    }
    if shortcut:
        m[f"{src}.skip_connection"] = f"{dst}.Conv2d"
    return m


def _attention(src: str, dst: str, num_blocks: int, linear_proj: bool) -> dict[str, str]:
    """Spatial transformer: norm + proj_in + N basic transformer blocks + proj_out.

    `src` uses the diffusers/LDM inner naming (identical for both formats);
    `dst` is the refiners ``*CrossAttention`` container path.
    """
    proj = "Linear" if linear_proj else "Conv2d"
    m = {
        f"{src}.norm": f"{dst}.Chain_1.GroupNorm",
        f"{src}.proj_in": f"{dst}.Chain_1.{proj}",
        f"{src}.proj_out": f"{dst}.Chain_3.{proj}",
    }
    for k in range(num_blocks):
        blk = "CrossAttentionBlock" if num_blocks == 1 else f"CrossAttentionBlock_{k + 1}"
        s = f"{src}.transformer_blocks.{k}"
        d = f"{dst}.Chain_2.{blk}"
        m |= {
            f"{s}.norm1": f"{d}.Residual_1.LayerNorm",
            f"{s}.attn1.to_q": f"{d}.Residual_1.SelfAttention.Distribute.Linear_1",
            f"{s}.attn1.to_k": f"{d}.Residual_1.SelfAttention.Distribute.Linear_2",
            f"{s}.attn1.to_v": f"{d}.Residual_1.SelfAttention.Distribute.Linear_3",
            f"{s}.attn1.to_out.0": f"{d}.Residual_1.SelfAttention.Linear",
            f"{s}.norm2": f"{d}.Residual_2.LayerNorm",
            f"{s}.attn2.to_q": f"{d}.Residual_2.Attention.Distribute.Linear_1",
            f"{s}.attn2.to_k": f"{d}.Residual_2.Attention.Distribute.Linear_2",
            f"{s}.attn2.to_v": f"{d}.Residual_2.Attention.Distribute.Linear_3",
            f"{s}.attn2.to_out.0": f"{d}.Residual_2.Attention.Linear",
            f"{s}.norm3": f"{d}.Residual_3.LayerNorm",
            f"{s}.ff.net.0.proj": f"{d}.Residual_3.Linear_1",
            f"{s}.ff.net.2": f"{d}.Residual_3.Linear_2",
        }
    return m


# -- SD 1.5 -------------------------------------------------------------------

_SD15_DOWN_SHORTCUT = {(1, 0), (2, 0)}  # stages where in_channels != out_channels


def sd15_unet_diffusers_key_map() -> dict[str, str]:
    """diffusers UNet2DConditionModel keys → reference layout (unet_sd15.py:5)."""
    m = {
        "time_embedding.linear_1": "TimestepEncoder.RangeEncoder.Linear_1",
        "time_embedding.linear_2": "TimestepEncoder.RangeEncoder.Linear_2",
        "conv_in": "DownBlocks.Chain_1.Conv2d",
        "conv_norm_out": "Chain.GroupNorm",
        "conv_out": "Chain.Conv2d",
    }
    c = 2
    for i in range(4):
        for j in range(2):
            dst = f"DownBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_diffusers(f"down_blocks.{i}.resnets.{j}", dst, (i, j) in _SD15_DOWN_SHORTCUT)
            if i < 3:
                m |= _attention(
                    f"down_blocks.{i}.attentions.{j}",
                    f"DownBlocks.Chain_{c}.CLIPLCrossAttention",
                    num_blocks=1,
                    linear_proj=False,
                )
            c += 1
        if i < 3:
            m[f"down_blocks.{i}.downsamplers.0.conv"] = f"DownBlocks.Chain_{c}.Downsample.Conv2d"
            c += 1
    m |= _resnet_diffusers("mid_block.resnets.0", "Sum.MiddleBlock.ResidualBlock_1", False)
    m |= _attention("mid_block.attentions.0", "Sum.MiddleBlock.CLIPLCrossAttention", 1, linear_proj=False)
    m |= _resnet_diffusers("mid_block.resnets.1", "Sum.MiddleBlock.ResidualBlock_2", False)
    c = 1
    for i in range(4):
        for j in range(3):
            dst = f"UpBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_diffusers(f"up_blocks.{i}.resnets.{j}", dst, True)
            if i >= 1:
                m |= _attention(
                    f"up_blocks.{i}.attentions.{j}",
                    f"UpBlocks.Chain_{c}.CLIPLCrossAttention",
                    num_blocks=1,
                    linear_proj=False,
                )
            if j == 2 and i < 3:
                m[f"up_blocks.{i}.upsamplers.0.conv"] = f"UpBlocks.Chain_{c}.Upsample.Conv2d"
            c += 1
    return m


def sd15_unet_civitai_key_map() -> dict[str, str]:
    """Original-LDM (civitai "model.diffusion_model.") keys → reference layout
    (unet_sd15.py:401)."""
    m = {
        "time_embed.0": "TimestepEncoder.RangeEncoder.Linear_1",
        "time_embed.2": "TimestepEncoder.RangeEncoder.Linear_2",
        "input_blocks.0.0": "DownBlocks.Chain_1.Conv2d",
        "out.0": "Chain.GroupNorm",
        "out.2": "Chain.Conv2d",
    }
    c, n = 2, 1
    for i in range(4):
        for j in range(2):
            dst = f"DownBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_ldm(f"input_blocks.{n}.0", dst, (i, j) in _SD15_DOWN_SHORTCUT)
            if i < 3:
                m |= _attention(
                    f"input_blocks.{n}.1",
                    f"DownBlocks.Chain_{c}.CLIPLCrossAttention",
                    num_blocks=1,
                    linear_proj=False,
                )
            c += 1
            n += 1
        if i < 3:
            m[f"input_blocks.{n}.0.op"] = f"DownBlocks.Chain_{c}.Downsample.Conv2d"
            c += 1
            n += 1
    m |= _resnet_ldm("middle_block.0", "Sum.MiddleBlock.ResidualBlock_1", False)
    m |= _attention("middle_block.1", "Sum.MiddleBlock.CLIPLCrossAttention", 1, linear_proj=False)
    m |= _resnet_ldm("middle_block.2", "Sum.MiddleBlock.ResidualBlock_2", False)
    c, n = 1, 0
    for i in range(4):
        for j in range(3):
            dst = f"UpBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_ldm(f"output_blocks.{n}.0", dst, True)
            if i >= 1:
                m |= _attention(
                    f"output_blocks.{n}.1",
                    f"UpBlocks.Chain_{c}.CLIPLCrossAttention",
                    num_blocks=1,
                    linear_proj=False,
                )
            if j == 2 and i < 3:
                # the upsampler shares the output block with the resnet (and
                # attention, when present): it takes the next sub-index
                sub = 2 if i >= 1 else 1
                m[f"output_blocks.{n}.{sub}.conv"] = f"UpBlocks.Chain_{c}.Upsample.Conv2d"
            c += 1
            n += 1
    return m


# -- SDXL ---------------------------------------------------------------------

_SDXL_ATTN_BLOCKS = {1: 2, 2: 10}  # stage → transformer depth (stage 0 has none)


def sdxl_unet_diffusers_key_map() -> dict[str, str]:
    """diffusers SDXL UNet keys → reference layout (unet_sdxl.py:5)."""
    m = {
        "time_embedding.linear_1": "TimestepEncoder.Sum.Chain.RangeEncoder.Linear_1",
        "time_embedding.linear_2": "TimestepEncoder.Sum.Chain.RangeEncoder.Linear_2",
        # LCM-distilled checkpoints carry a conditioning projection
        "time_embedding.cond_proj": "TimestepEncoder.Sum.Chain.RangeEncoder.ConditionScaleBlock.Linear",
        "add_embedding.linear_1": "TimestepEncoder.Sum.TextTimeEmbedding.Linear_1",
        "add_embedding.linear_2": "TimestepEncoder.Sum.TextTimeEmbedding.Linear_2",
        "conv_in": "DownBlocks.Chain_1.Conv2d",
        "conv_norm_out": "OutputBlock.GroupNorm",
        "conv_out": "OutputBlock.Conv2d",
    }
    c = 2
    for i in range(3):
        for j in range(2):
            dst = f"DownBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_diffusers(f"down_blocks.{i}.resnets.{j}", dst, i >= 1 and j == 0)
            if i in _SDXL_ATTN_BLOCKS:
                m |= _attention(
                    f"down_blocks.{i}.attentions.{j}",
                    f"DownBlocks.Chain_{c}.SDXLCrossAttention",
                    num_blocks=_SDXL_ATTN_BLOCKS[i],
                    linear_proj=True,
                )
            c += 1
        if i < 2:
            m[f"down_blocks.{i}.downsamplers.0.conv"] = f"DownBlocks.Chain_{c}.Downsample.Conv2d"
            c += 1
    m |= _resnet_diffusers("mid_block.resnets.0", "MiddleBlock.ResidualBlock_1", False)
    m |= _attention("mid_block.attentions.0", "MiddleBlock.SDXLCrossAttention", 10, linear_proj=True)
    m |= _resnet_diffusers("mid_block.resnets.1", "MiddleBlock.ResidualBlock_2", False)
    c = 1
    for i in range(3):
        depth = _SDXL_ATTN_BLOCKS.get(2 - i)  # up stages mirror down stages
        for j in range(3):
            dst = f"UpBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_diffusers(f"up_blocks.{i}.resnets.{j}", dst, True)
            if depth:
                m |= _attention(
                    f"up_blocks.{i}.attentions.{j}",
                    f"UpBlocks.Chain_{c}.SDXLCrossAttention",
                    num_blocks=depth,
                    linear_proj=True,
                )
            if j == 2 and i < 2:
                m[f"up_blocks.{i}.upsamplers.0.conv"] = f"UpBlocks.Chain_{c}.Upsample.Conv2d"
            c += 1
    return m


def sdxl_unet_civitai_key_map() -> dict[str, str]:
    """Original-LDM SDXL keys → reference layout (unet_sdxl.py:1061)."""
    m = {
        "time_embed.0": "TimestepEncoder.Sum.Chain.RangeEncoder.Linear_1",
        "time_embed.2": "TimestepEncoder.Sum.Chain.RangeEncoder.Linear_2",
        "label_emb.0.0": "TimestepEncoder.Sum.TextTimeEmbedding.Linear_1",
        "label_emb.0.2": "TimestepEncoder.Sum.TextTimeEmbedding.Linear_2",
        "input_blocks.0.0": "DownBlocks.Chain_1.Conv2d",
        "out.0": "OutputBlock.GroupNorm",
        "out.2": "OutputBlock.Conv2d",
    }
    c, n = 2, 1
    for i in range(3):
        for j in range(2):
            dst = f"DownBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_ldm(f"input_blocks.{n}.0", dst, i >= 1 and j == 0)
            if i in _SDXL_ATTN_BLOCKS:
                m |= _attention(
                    f"input_blocks.{n}.1",
                    f"DownBlocks.Chain_{c}.SDXLCrossAttention",
                    num_blocks=_SDXL_ATTN_BLOCKS[i],
                    linear_proj=True,
                )
            c += 1
            n += 1
        if i < 2:
            m[f"input_blocks.{n}.0.op"] = f"DownBlocks.Chain_{c}.Downsample.Conv2d"
            c += 1
            n += 1
    m |= _resnet_ldm("middle_block.0", "MiddleBlock.ResidualBlock_1", False)
    m |= _attention("middle_block.1", "MiddleBlock.SDXLCrossAttention", 10, linear_proj=True)
    m |= _resnet_ldm("middle_block.2", "MiddleBlock.ResidualBlock_2", False)
    c, n = 1, 0
    for i in range(3):
        depth = _SDXL_ATTN_BLOCKS.get(2 - i)
        for j in range(3):
            dst = f"UpBlocks.Chain_{c}.ResidualBlock"
            m |= _resnet_ldm(f"output_blocks.{n}.0", dst, True)
            if depth:
                m |= _attention(
                    f"output_blocks.{n}.1",
                    f"UpBlocks.Chain_{c}.SDXLCrossAttention",
                    num_blocks=depth,
                    linear_proj=True,
                )
            if j == 2 and i < 2:
                sub = 2 if depth else 1
                m[f"output_blocks.{n}.{sub}.conv"] = f"UpBlocks.Chain_{c}.Upsample.Conv2d"
            c += 1
            n += 1
    return m
