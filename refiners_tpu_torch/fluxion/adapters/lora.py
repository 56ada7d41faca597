"""LoRA adapters; counterpart of ``refiners_tpu/fluxion/adapters/lora.py``.

Checkpoint weights come in torch layout (Linear (out, in), Conv2d OIHW), as
CivitAI and diffusers state dicts hold them. That is the port's own layout,
so `from_weights` and `load_weights` take them as they are and
`checkpoint_weights` gives them back unchanged; the JAX package transposes
both ways. A LoRA on a `QuantizedLinear` is out of scope, as there
(`is_compatible` accepts `fl.Linear` only).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Generic, Iterable, Iterator, TypeVar, cast

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter

T = TypeVar("T", bound=fl.WeightedModule)


class Lora(Generic[T], fl.Chain, ABC):
    """down → up → Multiply(scale): the low-rank branch."""

    def __init__(
        self,
        name: str,
        /,
        rank: int = 16,
        scale: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.name = name
        self._rank = rank
        self._scale = scale
        super().__init__(
            *self.lora_layers(device=device, dtype=dtype),
            fl.Multiply(scale),
        )
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """down ~ N(0, 1/rank²) (standard deviation 1/rank); up = 0, so a new LoRA changes nothing."""
        weight = self.down.weight
        with torch.no_grad():
            if weight.device.type != "meta":
                weight.normal_(0.0, 1.0 / self.rank, generator=rng.generator(weight.device))
            self.up.weight.zero_()

    @abstractmethod
    def lora_layers(self, device: Any = None, dtype: Any = None) -> tuple[T, T]: ...

    @property
    def down(self) -> T:
        down_layer = self[0]
        assert isinstance(down_layer, fl.WeightedModule)
        return cast(T, down_layer)

    @property
    def up(self) -> T:
        up_layer = self[1]
        assert isinstance(up_layer, fl.WeightedModule)
        return cast(T, up_layer)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def scale(self) -> float:
        return self._scale

    @scale.setter
    def scale(self, value: float) -> None:
        self._scale = value
        self.ensure_find(fl.Multiply).scale = value

    @classmethod
    def from_weights(cls, name: str, /, down: torch.Tensor, up: torch.Tensor) -> "Lora[Any]":
        """A LoRA on the weights' device and dtype, from torch-layout down and up weights."""
        match (up.ndim, down.ndim):
            case (2, 2):
                return LinearLora.from_weights(name, up=up, down=down)
            case (4, 4):
                return Conv2dLora.from_weights(name, up=up, down=down)
            case _:
                raise ValueError(f"Unsupported weight shapes: up={up.shape}, down={down.shape}")

    @classmethod
    def from_dict(cls, name: str, /, state_dict: dict[str, torch.Tensor]) -> dict[str, "Lora[Any]"]:
        """Named LoRA layers from a state dict whose weights alternate down, up."""
        state_dict = {k: v for k, v in state_dict.items() if ".weight" in k}
        loras: dict[str, Lora[Any]] = {}
        for down_key, down_tensor, up_tensor in zip(
            list(state_dict.keys())[::2], list(state_dict.values())[::2], list(state_dict.values())[1::2]
        ):
            key = ".".join(down_key.split(".")[:-2])
            loras[key] = cls.from_weights(name, down=down_tensor, up=up_tensor)
        return loras

    @abstractmethod
    def is_compatible(self, layer: fl.WeightedModule, /) -> bool: ...

    def checkpoint_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(down, up) in torch layout, as `load_weights` takes them."""
        return self.down.weight.detach(), self.up.weight.detach()

    def auto_attach(
        self,
        target: fl.Chain,
        include: list[str] | None = None,
        exclude: list[str] | None = None,
    ) -> "tuple[LoraAdapter, fl.Chain | None] | None":
        """Find the first shape-compatible layer in `target` and wrap it.

        Returns the new adapter and the parent to inject it into, or an
        adapter already there that took this LoRA and None, or None."""
        return self._attach_first(target.walk(self.up.__class__), include=include, exclude=exclude)

    def _attach_first(
        self,
        candidates: Iterable[tuple[fl.WeightedModule, fl.Chain]],
        include: list[str] | None = None,
        exclude: list[str] | None = None,
    ) -> "tuple[LoraAdapter, fl.Chain | None] | None":
        """`auto_attach` over the (layer, parent) pairs of a walk."""
        for layer, parent in candidates:
            if isinstance(parent, Lora):
                continue
            # the cheap tests first (the shape, a LoRA of this name already there): they rule out
            # most layers before their parents are listed
            if not self.is_compatible(layer):
                continue
            if isinstance(parent, LoraAdapter) and self.name in parent.names:
                continue

            if include is not None or exclude is not None:
                names = {p.__class__.__name__ for p in (*parent.get_parents(), parent)}
                if include is not None and names.isdisjoint(include):
                    continue
                if exclude is not None and not names.isdisjoint(exclude):
                    continue

            if isinstance(parent, LoraAdapter):
                parent.add_lora(self)
                return parent, None

            return LoraAdapter(layer, self), parent
        return None

    def load_weights(self, down_weight: torch.Tensor, up_weight: torch.Tensor) -> None:
        """Copy torch-layout weights in, cast to this LoRA's dtype and device."""
        assert down_weight.shape == self.down.weight.shape, f"{down_weight.shape} != {self.down.weight.shape}"
        assert up_weight.shape == self.up.weight.shape, f"{up_weight.shape} != {self.up.weight.shape}"
        with torch.no_grad():
            self.down.weight.copy_(down_weight)
            self.up.weight.copy_(up_weight)


class LinearLora(Lora[fl.Linear]):
    """LoRA for Linear layers: down (rank, in), up (out, rank)."""

    def __init__(
        self,
        name: str,
        /,
        in_features: int,
        out_features: int,
        rank: int = 16,
        scale: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.in_features = in_features
        self.out_features = out_features
        super().__init__(name, rank=rank, scale=scale, device=device, dtype=dtype)

    @classmethod
    def from_weights(cls, name: str, /, down: torch.Tensor, up: torch.Tensor) -> "LinearLora":
        assert up.ndim == 2 and down.ndim == 2
        assert down.shape[0] == up.shape[1], f"Rank mismatch: down rank={down.shape[0]} and up rank={up.shape[1]}"
        lora = cls(
            name,
            in_features=down.shape[1],
            out_features=up.shape[0],
            rank=down.shape[0],
            device=up.device,
            dtype=up.dtype,
        )
        lora.load_weights(down_weight=down, up_weight=up)
        return lora

    def lora_layers(self, device: Any = None, dtype: Any = None) -> tuple[fl.Linear, fl.Linear]:
        return (
            fl.Linear(self.in_features, self.rank, bias=False, device=device, dtype=dtype),
            fl.Linear(self.rank, self.out_features, bias=False, device=device, dtype=dtype),
        )

    def is_compatible(self, layer: fl.WeightedModule, /) -> bool:
        return (
            isinstance(layer, fl.Linear)
            and layer.in_features == self.in_features
            and layer.out_features == self.out_features
        )


class Conv2dLora(Lora[fl.Conv2d]):
    """LoRA for Conv2d layers: down (rank, in, kh, kw), up (out, rank, kh, kw);
    1×1 and 3×3 kernels padded to keep the spatial size."""

    def __init__(
        self,
        name: str,
        /,
        in_channels: int,
        out_channels: int,
        rank: int = 16,
        scale: float = 1.0,
        kernel_size: tuple[int, int] = (1, 3),
        stride: tuple[int, int] = (1, 1),
        padding: tuple[int, int] = (0, 1),
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        super().__init__(name, rank=rank, scale=scale, device=device, dtype=dtype)

    @classmethod
    def from_weights(cls, name: str, /, down: torch.Tensor, up: torch.Tensor) -> "Conv2dLora":
        assert up.ndim == 4 and down.ndim == 4
        assert down.shape[0] == up.shape[1], f"Rank mismatch: down rank={down.shape[0]} and up rank={up.shape[1]}"
        down_kernel_size, up_kernel_size = down.shape[2], up.shape[2]
        lora = cls(
            name,
            in_channels=down.shape[1],
            out_channels=up.shape[0],
            rank=down.shape[0],
            kernel_size=(down_kernel_size, up_kernel_size),
            padding=(1 if down_kernel_size == 3 else 0, 1 if up_kernel_size == 3 else 0),
            device=up.device,
            dtype=up.dtype,
        )
        lora.load_weights(down_weight=down, up_weight=up)
        return lora

    def lora_layers(self, device: Any = None, dtype: Any = None) -> tuple[fl.Conv2d, fl.Conv2d]:
        return (
            fl.Conv2d(
                self.in_channels,
                self.rank,
                kernel_size=self.kernel_size[0],
                stride=self.stride[0],
                padding=self.padding[0],
                use_bias=False,
                device=device,
                dtype=dtype,
            ),
            fl.Conv2d(
                self.rank,
                self.out_channels,
                kernel_size=self.kernel_size[1],
                stride=self.stride[1],
                padding=self.padding[1],
                use_bias=False,
                device=device,
                dtype=dtype,
            ),
        )

    def is_compatible(self, layer: fl.WeightedModule, /) -> bool:
        if (
            isinstance(layer, fl.Conv2d)
            and layer.in_channels == self.in_channels
            and layer.out_channels == self.out_channels
        ):
            # the weights do not say the stride: take the target's
            self.down.stride = layer.stride
            return True
        return False


class LoraAdapter(fl.Sum, Adapter[fl.WeightedModule]):
    """Sum(target, *loras), with the LoRAs managed by name."""

    def __init__(self, target: fl.WeightedModule, /, *loras: Lora[Any]) -> None:
        with self.setup_adapter(target):
            super().__init__(target, *loras)

    @property
    def lora_layers(self) -> Iterator[Lora[Any]]:
        # the adapter's children: its target (a weighted leaf) and the LoRAs
        return (module for module in self if isinstance(module, Lora))

    @property
    def names(self) -> list[str]:
        return [lora.name for lora in self.lora_layers]

    @property
    def loras(self) -> dict[str, Lora[Any]]:
        return {lora.name: lora for lora in self.lora_layers}

    @property
    def scales(self) -> dict[str, float]:
        return {lora.name: lora.scale for lora in self.lora_layers}

    @scales.setter
    def scales(self, values: dict[str, float]) -> None:
        for name, value in values.items():
            self.loras[name].scale = value

    # the JAX package's name for the setter
    scale = scales

    def add_lora(self, lora: Lora[Any], /) -> None:
        assert lora.name not in self.names, f"LoRA layer with name {lora.name} already exists"
        self.append(lora)

    def remove_lora(self, name: str, /) -> Lora[Any] | None:
        if name in self.names:
            lora = self.loras[name]
            self.remove(lora)
            return lora
        return None


def _auto_attach_loras(
    loras: dict[str, Lora[Any]],
    target: fl.Chain,
    /,
    include: list[str] | None = None,
    exclude: list[str] | None = None,
    debug_map: list[tuple[str, str]] | None = None,
) -> list[str]:
    failed_keys: list[str] = []
    # Each LoRA takes the first fit in the same walk of `target`: the walk is listed once per layer
    # type and kept current (an injected adapter becomes its layer's parent, at the layer's place;
    # the LoRAs' own layers, which the walk would skip, are left out), not walked again per LoRA.
    walks: dict[type, list[tuple[Any, fl.Chain]]] = {}
    positions: dict[int, int] = {}
    for key, lora in loras.items():
        layer_type = lora.up.__class__
        if layer_type not in walks:
            walks[layer_type] = [(l, p) for l, p in target.walk(layer_type) if not isinstance(p, Lora)]
            positions.update((id(l), i) for i, (l, _) in enumerate(walks[layer_type]))
        if attached := lora._attach_first(walks[layer_type], include=include, exclude=exclude):
            adapter, parent = attached
            if parent is None:
                # an adapter already in place took the LoRA
                if debug_map is not None:
                    debug_map.append((key, adapter.get_path()))
                continue
            if debug_map is not None:
                debug_map.append((key, adapter.target.get_path(parent)))
            adapter.inject(parent)
            walks[layer_type][positions[id(adapter.target)]] = (adapter.target, adapter)
        else:
            failed_keys.append(key)
    return failed_keys


def auto_attach_loras(
    loras: dict[str, Lora[Any]],
    target: fl.Chain,
    /,
    include: list[str] | None = None,
    exclude: list[str] | None = None,
    sanity_check: bool = True,
    debug_map: list[tuple[str, str]] | None = None,
) -> list[str]:
    """Attach many LoRAs; the keys that found no layer are returned.

    With `sanity_check`, every LoRA must attach, and attaching copies of them
    again must attach none (each layer takes one LoRA of a name)."""
    if not sanity_check:
        return _auto_attach_loras(loras, target, include=include, exclude=exclude, debug_map=debug_map)

    loras_copy = {key: Lora.from_weights(lora.name, *lora.checkpoint_weights()) for key, lora in loras.items()}
    debug_map_1: list[tuple[str, str]] = []
    failed_keys_1 = _auto_attach_loras(loras, target, include=include, exclude=exclude, debug_map=debug_map_1)
    if debug_map is not None:
        debug_map += debug_map_1
    if len(debug_map_1) != len(loras) or failed_keys_1:
        raise ValueError(
            f"sanity check failed: {len(debug_map_1)} / {len(loras)} LoRA layers attached, {len(failed_keys_1)} failed"
        )

    debug_map_2: list[tuple[str, str]] = []
    failed_keys_2 = _auto_attach_loras(loras_copy, target, include=include, exclude=exclude, debug_map=debug_map_2)
    if debug_map_2 or len(failed_keys_2) != len(loras):
        raise ValueError(
            f"sanity check failed: {len(debug_map_2)} / {len(loras)} LoRA layers attached twice, "
            f"{len(failed_keys_2)} skipped"
        )
    return failed_keys_1
