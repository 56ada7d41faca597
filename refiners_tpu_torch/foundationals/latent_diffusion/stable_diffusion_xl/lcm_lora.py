"""LCM-LoRA (arXiv:2311.05556) for SDXL; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/lcm_lora.py``.

`add_lcm_lora` also attaches LoRAs of the same structure, such as
SDXL-Lightning's (arXiv:2402.13929)."""

from __future__ import annotations

import torch

from refiners_tpu_torch.fluxion.adapters.lora import Lora, auto_attach_loras
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import StableDiffusion_XL


def _check_validity(debug_map: list[tuple[str, str]]) -> None:
    """Each key of a diffusers block attached inside the UNet blocks it maps to."""
    prefix_map = {
        "down_blocks_0": ["DownBlocks.Chain_1", "DownBlocks.Chain_2", "DownBlocks.Chain_3", "DownBlocks.Chain_4"],
        "down_blocks_1": ["DownBlocks.Chain_5", "DownBlocks.Chain_6", "DownBlocks.Chain_7"],
        "down_blocks_2": ["DownBlocks.Chain_8", "DownBlocks.Chain_9"],
        "mid_block": ["MiddleBlock"],
        "up_blocks_0": ["UpBlocks.Chain_1", "UpBlocks.Chain_2", "UpBlocks.Chain_3"],
        "up_blocks_1": ["UpBlocks.Chain_4", "UpBlocks.Chain_5", "UpBlocks.Chain_6"],
        "up_blocks_2": ["UpBlocks.Chain_7", "UpBlocks.Chain_8", "UpBlocks.Chain_9"],
    }
    for key, path in debug_map:
        for key_pfx, paths_pfxs in prefix_map.items():
            if key.startswith(f"lora_unet_{key_pfx}"):
                assert any(path.startswith(f"SDXLUNet.{x}") for x in paths_pfxs), f"bad mapping: {key} {path}"


def add_lcm_lora(
    manager: SDLoraManager,
    tensors: dict[str, torch.Tensor],
    name: str = "lcm",
    scale: float = 8.0 / 64.0,
    check_validity: bool = True,
) -> None:
    """Attach an LCM-LoRA (UNet keys only, `lora_unet_*`) in two passes: the
    transformers' `proj_in`/`proj_out` first, inside `SDXLCrossAttention` but
    outside its `CrossAttentionBlock`s, then the rest as `add_loras_to_unet`
    does. The weights are moved to the UNet's device and dtype."""
    assert isinstance(manager.target, StableDiffusion_XL)
    unet = manager.target.unet

    device, dtype = unet.device, unet.dtype
    loras = Lora.from_dict(name, {k: v.to(device=device, dtype=dtype) for k, v in tensors.items()})
    assert all(k.startswith("lora_unet_") for k in loras.keys())
    loras = {k: loras[k] for k in sorted(loras.keys(), key=SDLoraManager.sort_keys)}

    debug_map: list[tuple[str, str]] | None = [] if check_validity else None

    # the projections are Linears of SDXLCrossAttention but not of its CrossAttentionBlocks
    loras_projs = {k: v for k, v in loras.items() if k.endswith("proj_in") or k.endswith("proj_out")}
    auto_attach_loras(
        loras_projs,
        unet,
        exclude=["CrossAttentionBlock"],
        include=["SDXLCrossAttention"],
        debug_map=debug_map,
    )

    manager.add_loras_to_unet(
        {k: v for k, v in loras.items() if k not in loras_projs},
        debug_map=debug_map,
    )

    if debug_map is not None:
        _check_validity(debug_map)

    manager.set_scale(name, scale)
