"""A LoRA (arXiv:2106.09685) on every Linear of the U-Net's transformers,
drawn from the run's seed in the reference (kohya) key layout
``lora_unet_<n>.lora_down.weight`` / ``.lora_up.weight``, keyed in the
order of the tree: attached to the port through
``SDLoraManager.add_loras``, merged into the reference's weights
(W + scale · up · down).

The down projection has unit output scale (1/√in); the up projection is
scaled so that the LoRA at scale 1 moves its layer's output by about 30 %
(the settings of ``chip_smoke.py``'s SDXL LoRAs).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from h100_bench.reference.diffusion import model_spec
from h100_bench.weights import derive


def targets(cfg: dict[str, Any]) -> list[tuple[str, int, int]]:
    """(key, out, in) of every Linear weight inside the U-Net's transformers, in tree order."""
    block = "CLIPLCrossAttention" if cfg["family"] == "sd1" else "SDXLCrossAttention"
    return [(k[len("unet.") :], s[0], s[1]) for k, s in model_spec(cfg).items()
            if k.startswith("unet.") and f".{block}." in k and k.endswith(".weight") and len(s) == 2]  # fmt: skip


def tensors(cfg: dict[str, Any], params: dict[str, Any], seed: int, device: Any, dtype: Any) -> dict[str, torch.Tensor]:
    rank, layers = params["rank"], targets(cfg)
    total = sum(rank * (i + o) for _, o, i in layers)
    generator = torch.Generator(device).manual_seed(derive(seed, f"lora:{params['name']}"))
    flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
    out, offset = {}, 0
    with torch.no_grad():
        for n, (_, o, i) in enumerate(layers):
            down = flat[offset : offset + rank * i].view(rank, i).mul_(1 / math.sqrt(i))
            offset += rank * i
            up = flat[offset : offset + o * rank].view(o, rank).mul_(0.3 / math.sqrt(rank))
            offset += o * rank
            out[f"lora_unet_{n:04d}.lora_down.weight"], out[f"lora_unet_{n:04d}.lora_up.weight"] = down, up
    return out


def attach(sd: Any, cfg: dict[str, Any], params: dict[str, Any], seed: int, device: Any) -> None:
    from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager

    weights = tensors(cfg, params, seed, device, sd.unet.dtype)
    manager = SDLoraManager(sd)
    manager.add_loras(params["name"], tensors=weights, scale=params["scale"])
    attached = sum(1 for lora in manager.loras if lora.name == params["name"])
    if attached != len(weights) // 2:
        raise RuntimeError(f"LoRA {params['name']}: {attached} of {len(weights) // 2} layers attached")


def detach(sd: Any, params: dict[str, Any]) -> None:
    from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager

    SDLoraManager(sd).remove_loras(params["name"])


def reference_weights(weights: dict[str, torch.Tensor], cfg: dict[str, Any], params: dict[str, Any], seed: int,
                      device: Any) -> dict[str, torch.Tensor]:  # fmt: skip
    """`weights` with the LoRA merged into its targets, in float32."""
    lora = tensors(cfg, params, seed, device, next(iter(weights.values())).dtype)
    merged = dict(weights)
    for n, (key, _, _) in enumerate(targets(cfg)):
        down, up = lora[f"lora_unet_{n:04d}.lora_down.weight"], lora[f"lora_unet_{n:04d}.lora_up.weight"]
        merged[f"unet.{key}"] = merged[f"unet.{key}"].float() + params["scale"] * (up.float() @ down.float())
    return merged
