"""Control-LoRA (SDXL) conversion: original stability-ai checkpoints →
refiners hub layout; counterpart of
``refiners_tpu/conversion/models/control_lora_sdxl.py``.

The original format is LDM-style (`.up`/`.down` LoRA pairs,
`input_hint_block`, `zero_convs`, `middle_block_out`); the converted format
keys LoRAs by their target path under `ControlLora.`, zero convolutions as
`ZeroConvolution_{i:02d}.…` and the condition encoder under
`ConditionEncoder.…`, all in torch layouts (the reference refiners'
``conversion/models/controllora_sdxl.py``), which are the port's own.
"""

from __future__ import annotations

from typing import Any

from refiners_tpu_torch.conversion.utils import Hub, as_tensor

canny_original = Hub(
    repo_id="lllyasviel/misc",
    filename="control-lora-canny-rank128.safetensors",
    revision="71f7a66a7affe631c64af469fe647217d422cac0",
    expected_sha256="56389dbb245ca44de91d662529bd4298abc55ce2318f60bc19454fb72ff68247",
)
canny_converted = Hub(
    repo_id="refiners/sdxl.controllora.canny",
    filename="model.safetensors",
    expected_sha256="6edfa742e2b5191ce357fb559e236652b004feea490c4f1277b30abc9804321f",
)
cpds_original = Hub(
    repo_id="lllyasviel/misc",
    filename="fooocus_xl_cpds_128.safetensors",
    revision="71f7a66a7affe631c64af469fe647217d422cac0",
    expected_sha256="eec3fd8209a65b41341ea9f415de66909c97b30fb4d20965b3304e8e5251c2f1",
)
cpds_converted = Hub(
    repo_id="refiners/sdxl.controllora.cpds",
    filename="model.safetensors",
    expected_sha256="9a3b2a86f32e4747e98531b0af8b59a804391b538949a0dd85263722b6e64db0",
)


def _simplify_key(key: str, prefix: str, index: int | None = None) -> str:
    """Strip everything left of `prefix`, optionally zero-pad-index it."""
    _, right = key.split(prefix, maxsplit=1)
    if index:
        return f"{prefix}_{index:02d}{right}"
    return f"{prefix}{right}"


def convert_controllora_sdxl(state_dict: dict[str, Any], name: str = "converted") -> dict[str, Any]:
    """Original control-lora checkpoint → refiners-hub-layout state dict.

    Builds a ControlLora over a full-width SDXLUNet, loads the original
    weights through the runtime loader (LoRAs auto-attached with the
    original key-sort heuristics), then reads every weight back out keyed by
    its tree path. The UNet is built on ``meta``: the ControlLora shares its
    layers, and only their shapes are read (to attach the LoRAs); the
    condition encoder and the zero convolutions, which it owns, are
    materialized on the CPU.
    """
    import refiners_tpu_torch.fluxion.layers as fl
    from refiners_tpu_torch.fluxion.adapters.lora import Lora, LoraAdapter
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.control_lora import (
        ConditionEncoder,
        ControlLoraAdapter,
        ZeroConvolution,
    )
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

    unet = SDXLUNet(in_channels=4, device="meta")
    adapter = ControlLoraAdapter(target=unet, name=name).inject()
    control_lora = adapter.control_lora
    for owned in (ConditionEncoder, ZeroConvolution):
        for layer in control_lora.layers(owned, recurse=True):
            layer.to_empty(device="cpu")
    adapter.load_original_weights({key: as_tensor(value) for key, value in state_dict.items()})

    converted: dict[str, Any] = {}

    # LoRAs: keyed by target path relative to the ControlLora. Eject the
    # adapters first so each path reads as if never injected: the runtime
    # loader resolves these paths on a bare tree.
    entries: list[tuple[Any, LoraAdapter]] = []
    for lora in control_lora.layers(Lora, recurse=True):
        lora_adapter = lora.parent
        assert isinstance(lora_adapter, LoraAdapter)
        entries.append((lora, lora_adapter))
    for _, lora_adapter in entries:
        lora_adapter.eject()
    for lora, lora_adapter in entries:
        target = lora_adapter.target
        path = target.get_path(parent=control_lora.ensure_find_parent(target))
        down, up = lora.checkpoint_weights()
        converted[_simplify_key(f"{path}.down", "ControlLora.")] = down
        converted[_simplify_key(f"{path}.up", "ControlLora.")] = up

    # zero convolutions: ZeroConvolution_{i:02d}.Conv2d.*
    for i, zero in enumerate(control_lora.layers(ZeroConvolution, recurse=True)):
        conv = zero.ensure_find(fl.Conv2d)
        key = _simplify_key(f"{zero.get_path()}.Conv2d", "ZeroConvolution", i + 1)
        converted[f"{key}.weight"] = conv.weight.detach()
        if conv.bias is not None:
            converted[f"{key}.bias"] = conv.bias.detach()

    # condition encoder convolutions; walk yields (module, parent)
    encoder = control_lora.ensure_find(ConditionEncoder)
    for conv, conv_parent in encoder.walk(fl.Conv2d, recurse=True):
        key = _simplify_key(conv.get_path(parent=conv_parent), "ConditionEncoder")
        converted[f"{key}.weight"] = conv.weight.detach()
        if conv.bias is not None:
            converted[f"{key}.bias"] = conv.bias.detach()

    adapter.eject()
    return converted
