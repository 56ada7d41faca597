"""Upstream key map for SD1.5 ControlNet (diffusers format); counterpart of
``refiners_tpu/conversion/models/controlnet.py``.

A ControlNet is the SD1.5 UNet's down+mid half with a condition encoder and
zero-convolution output taps; the generator reuses the UNet sub-block
patterns (the reference refiners' table: ``conversion/models/controlnet_sd15.py``).
"""

from __future__ import annotations

from refiners_tpu_torch.conversion.models.diffusion_unet import (
    _SD15_DOWN_SHORTCUT,
    _attention,
    _resnet_diffusers,
)


def controlnet_sd15_diffusers_key_map() -> dict[str, str]:
    m = {
        "time_embedding.linear_1": "TimestepEncoder.RangeEncoder.Linear_1",
        "time_embedding.linear_2": "TimestepEncoder.RangeEncoder.Linear_2",
        "conv_in": "DownBlocks.Chain_1.Conv2d",
        # condition encoder (hint network)
        "controlnet_cond_embedding.conv_in": "DownBlocks.Chain_1.Residual.ConditionEncoder.Chain_1.Conv2d",
        "controlnet_cond_embedding.conv_out": "DownBlocks.Chain_1.Residual.ConditionEncoder.Conv2d",
        # zero convolutions
        "controlnet_mid_block": "MiddleBlock.Passthrough.Conv2d",
    }
    for b in range(6):
        m[f"controlnet_cond_embedding.blocks.{b}"] = (
            f"DownBlocks.Chain_1.Residual.ConditionEncoder.Chain_{b // 2 + 2}.Conv2d_{b % 2 + 1}"
        )
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
    for n in range(12):
        m[f"controlnet_down_blocks.{n}"] = f"DownBlocks.Chain_{n + 1}.Passthrough.Conv2d"
    m |= _resnet_diffusers("mid_block.resnets.0", "MiddleBlock.ResidualBlock_1", False)
    m |= _attention("mid_block.attentions.0", "MiddleBlock.CLIPLCrossAttention", 1, linear_proj=False)
    m |= _resnet_diffusers("mid_block.resnets.1", "MiddleBlock.ResidualBlock_2", False)
    return m
