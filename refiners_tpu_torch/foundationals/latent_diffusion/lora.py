"""SDLoraManager: load CivitAI-style LoRA state dicts onto SD models.

Counterpart of ``refiners_tpu/foundationals/latent_diffusion/lora.py``. Keys
are matched to layers through the module tree (the same tree, and so the
same attachment, as the JAX package's); weights stay in torch layout.
"""

from __future__ import annotations

from typing import Any, Iterator, cast

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.lora import Lora, LoraAdapter, auto_attach_loras
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel


class SDLoraManager:
    """Manage named LoRAs (sets of LoRA layers) on a Stable Diffusion model."""

    def __init__(self, target: LatentDiffusionModel) -> None:
        self.target = target

    @property
    def unet(self) -> fl.Chain:
        unet = self.target.unet
        assert isinstance(unet, fl.Chain)
        return unet

    @property
    def clip_text_encoder(self) -> fl.Chain:
        clip_text_encoder = self.target.clip_text_encoder
        assert isinstance(clip_text_encoder, fl.Chain)
        return clip_text_encoder

    def add_loras(
        self,
        name: str,
        /,
        tensors: dict[str, torch.Tensor],
        scale: float = 1.0,
        unet_inclusions: list[str] | None = None,
        unet_exclusions: list[str] | None = None,
        unet_preprocess: dict[str, str] | None = None,
        text_encoder_inclusions: list[str] | None = None,
        text_encoder_exclusions: list[str] | None = None,
    ) -> None:
        """Load one named LoRA from a CivitAI-style state dict.

        The weights are moved to the UNet's device and dtype. Keys that name
        neither "unet" nor "text" are all taken for the UNet."""
        assert name not in self.names, f"LoRA {name} already exists"

        device, dtype = self.unet.device, self.unet.dtype
        loras = Lora.from_dict(name, state_dict={k: v.to(device=device, dtype=dtype) for k, v in tensors.items()})
        loras = {key: loras[key] for key in sorted(loras.keys(), key=SDLoraManager.sort_keys)}

        if all("unet" not in key and "text" not in key for key in loras.keys()):
            loras = {f"unet_{key}": value for key, value in loras.items()}

        self.add_loras_to_unet(loras, include=unet_inclusions, exclude=unet_exclusions, preprocess=unet_preprocess)
        self.add_loras_to_text_encoder(loras, include=text_encoder_inclusions, exclude=text_encoder_exclusions)
        self.set_scale(name, scale)

    def _get_lora_weights(self, base: fl.Chain, name: str, accum: dict[str, torch.Tensor]) -> None:
        prev_parent: fl.Chain | None = None
        n = 0
        for lora_adapter, parent in base.walk(LoraAdapter):
            lora = next((l for l in lora_adapter.lora_layers if l.name == name), None)
            if lora is None:
                continue
            n = n + 1 if parent is prev_parent else 1
            pfx = f"{parent.get_path()}.{n}.{lora_adapter.target.__class__.__name__}"
            accum[f"{pfx}.down.weight"], accum[f"{pfx}.up.weight"] = lora.checkpoint_weights()
            prev_parent = parent

    def get_lora_weights(self, name: str) -> dict[str, torch.Tensor]:
        """The torch-layout down and up weights of every layer of LoRA `name`."""
        r: dict[str, torch.Tensor] = {}
        self._get_lora_weights(self.unet, name, r)
        self._get_lora_weights(self.clip_text_encoder, name, r)
        return r

    def add_loras_to_text_encoder(
        self,
        loras: dict[str, Lora[Any]],
        /,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
        debug_map: list[tuple[str, str]] | None = None,
    ) -> None:
        text_encoder_loras = {key: loras[key] for key in loras.keys() if "text" in key}
        auto_attach_loras(
            text_encoder_loras, self.clip_text_encoder, exclude=exclude, include=include, debug_map=debug_map
        )

    def add_loras_to_unet(
        self,
        loras: dict[str, Lora[Any]],
        /,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
        preprocess: dict[str, str] | None = None,
        debug_map: list[tuple[str, str]] | None = None,
    ) -> None:
        """Attach the "unet" keys: those naming a block kind of `preprocess`
        ("res", "downsample", "upsample") only inside that kind of block, the
        rest outside them; `exclude` defaults to the TimestepEncoder."""
        unet_loras = {key: loras[key] for key in loras.keys() if "unet" in key}

        if exclude is None:
            exclude = ["TimestepEncoder"]
        if preprocess is None:
            preprocess = {"res": "ResidualBlock", "downsample": "Downsample", "upsample": "Upsample"}
        if include is not None:
            preprocess = {k: v for k, v in preprocess.items() if v in include}
        preprocess = {k: v for k, v in preprocess.items() if v not in exclude}

        loras_excluded = {k: v for k, v in unet_loras.items() if any(x in k for x in preprocess.keys())}
        loras_remaining = {k: v for k, v in unet_loras.items() if k not in loras_excluded}

        for exc_k, exc_v in preprocess.items():
            ls = {k: v for k, v in loras_excluded.items() if exc_k in k}
            auto_attach_loras(ls, self.unet, include=[exc_v], exclude=exclude, debug_map=debug_map)

        auto_attach_loras(
            loras_remaining,
            self.unet,
            exclude=[*exclude, *preprocess.values()],
            include=include,
            debug_map=debug_map,
        )

    def remove_loras(self, *names: str) -> None:
        """Remove the named LoRAs; an adapter left with none is ejected."""
        for lora_adapter in self.lora_adapters:
            for name in names:
                lora_adapter.remove_lora(name)
            if len(lora_adapter.loras) == 0:
                lora_adapter.eject()

    def remove_all(self) -> None:
        for lora_adapter in self.lora_adapters:
            lora_adapter.eject()

    def get_loras_by_name(self, name: str, /) -> list[Lora[Any]]:
        return [lora for lora in self.loras if lora.name == name]

    def get_scale(self, name: str, /) -> float:
        loras = self.get_loras_by_name(name)
        assert all([lora.scale == loras[0].scale for lora in loras]), "lora scales are not all the same"
        return loras[0].scale

    def set_scale(self, name: str, scale: float, /) -> None:
        self.update_scales({name: scale})

    def update_scales(self, scales: dict[str, float], /) -> None:
        assert all([name in self.names for name in scales]), f"Scales keys must be a subset of {self.names}"
        for name, scale in scales.items():
            for lora in self.get_loras_by_name(name):
                lora.scale = scale

    @property
    def loras(self) -> list[Lora[Any]]:
        unet_layers = cast(Iterator[Lora[Any]], self.unet.layers(Lora))
        text_encoder_layers = cast(Iterator[Lora[Any]], self.clip_text_encoder.layers(Lora))
        return [*unet_layers, *text_encoder_layers]

    @property
    def names(self) -> list[str]:
        return list(set(lora.name for lora in self.loras))

    @property
    def lora_adapters(self) -> list[LoraAdapter]:
        return list(self.unet.layers(LoraAdapter)) + list(self.clip_text_encoder.layers(LoraAdapter))

    @property
    def scales(self) -> dict[str, float]:
        return {name: self.get_scale(name) for name in self.names}

    @staticmethod
    def _pad(input: str, /, padding_length: int = 2) -> str:
        """Zero-pad numeric components so that keys sort numerically."""
        return "_".join(s.zfill(padding_length) if s.isdigit() else s for s in input.split("_"))

    @staticmethod
    def sort_keys(key: str, /) -> tuple[str, int]:
        """Sort keys by their stem, then by suffix: q → k → v, in → out."""
        suffix_scores = {"q": 1, "k": 2, "v": 3, "in": 3, "out": 4, "out0": 4, "out_0": 4}
        patterns = ["_{}", "_{}_lora"]
        key_char_order = {f.format(k): v for k, v in suffix_scores.items() for f in patterns}
        (sfx, score) = next(((k, v) for k, v in key_char_order.items() if key.endswith(k)), ("", 5))
        return (SDLoraManager._pad(key.removesuffix(sfx)), score)
