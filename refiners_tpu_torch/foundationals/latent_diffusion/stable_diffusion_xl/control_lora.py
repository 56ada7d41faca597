"""Control-LoRA for SDXL; counterpart of
``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/control_lora.py``.

A `ControlLora` is a structural copy of the UNet's timestep encoder, down
blocks and middle block: its chains are its own, its weighted layers the
UNet's (no new memory for them). LoRAs, a condition encoder and zero
convolutions patch the copy, which then writes scaled residuals into the
UNet's skips, as a ControlNet does. The LoRAs wrap the shared layers inside
the copy's chains only, so the UNet's own path is left as it was.

Weights come in torch layout (Linear (out, in), Conv2d OIHW), the port's
own, in both formats `ControlLoraAdapter` reads: the refiners layout
(`load_weights`) and stability-ai's original Control-LoRA checkpoints
(`load_original_weights`).
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.adapters.lora import Lora, LoraAdapter, auto_attach_loras
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.fluxion.layers import Chain, Conv2d, Multiply, Passthrough, Residual, SiLU, UseContext
from refiners_tpu_torch.fluxion.layers.module import WeightedModule
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.range_adapter import RangeAdapter2d
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet
from refiners_tpu_torch.foundationals.latent_diffusion.unet import ResidualAccumulator, ResidualBlock


class ConditionEncoder(Chain):
    """(B, 3, H, W) condition image → (B, 320, H/8, W/8) features."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 320,
        intermediate_channels: tuple[int, ...] = (16, 32, 96, 256),
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(
            Chain(
                Conv2d(
                    in_channels=in_channels,
                    out_channels=intermediate_channels[0],
                    kernel_size=3,
                    stride=1,
                    padding=1,
                    device=device,
                    dtype=dtype,
                ),
                SiLU(),
            ),
            *(
                Chain(
                    Conv2d(
                        in_channels=intermediate_channels[i],
                        out_channels=intermediate_channels[i],
                        kernel_size=3,
                        padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    SiLU(),
                    Conv2d(
                        in_channels=intermediate_channels[i],
                        out_channels=intermediate_channels[i + 1],
                        kernel_size=3,
                        stride=2,
                        padding=1,
                        device=device,
                        dtype=dtype,
                    ),
                    SiLU(),
                )
                for i in range(len(intermediate_channels) - 1)
            ),
            Conv2d(
                in_channels=intermediate_channels[-1],
                out_channels=out_channels,
                kernel_size=3,
                padding=1,
                device=device,
                dtype=dtype,
            ),
        )


class ZeroConvolution(Passthrough):
    """A 1×1 convolution, scaled, added to the UNet's skip residual `residual_index`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        residual_index: int,
        scale: float = 1.0,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        self._scale = scale
        super().__init__(
            Conv2d(in_channels=in_channels, out_channels=out_channels, kernel_size=1, device=device, dtype=dtype),
            Multiply(scale=scale),
            ResidualAccumulator(n=residual_index),
        )

    @property
    def scale(self) -> float:
        return self._scale

    @scale.setter
    def scale(self, value: float) -> None:
        self._scale = value
        self.ensure_find(Multiply).scale = value


class ControlLora(Passthrough):
    """The UNet's first half, copied onto the same weights, with a condition
    encoder after its first convolution and zero convolutions in place of its
    skip accumulators (see https://github.com/HighCWu/control-lora-v2). Its
    new layers are built on the UNet's device and in its dtype."""

    def __init__(self, name: str, unet: SDXLUNet, scale: float = 1.0, condition_channels: int = 3) -> None:
        self.name = name
        device, dtype = unet.device, unet.dtype
        timestep_encoder = unet.layer("TimestepEncoder", Chain).structural_copy()
        downblocks = unet.layer("DownBlocks", Chain).structural_copy()
        middle_block = unet.layer("MiddleBlock", Chain).structural_copy()
        super().__init__(timestep_encoder, downblocks, middle_block)

        # the copy's own timestep embedding, apart from the UNet's
        timestep_encoder.context_key = f"timestep_embedding_control_lora_{name}"
        for range_adapter in self.layers(RangeAdapter2d):
            range_adapter.context_key = f"timestep_embedding_control_lora_{name}"

        first_downblock = downblocks.layer(0, Chain)
        out_channels = first_downblock.layer(0, Conv2d).out_channels
        first_downblock.append(
            Residual(
                UseContext(f"control_lora_{name}", "condition"),
                ConditionEncoder(
                    in_channels=condition_channels, out_channels=out_channels, device=device, dtype=dtype
                ),
            )
        )

        # each skip accumulator becomes a zero convolution writing the same skip
        for residual_accumulator in list(self.layers(ResidualAccumulator, recurse=True)):
            downblock = self.ensure_find_parent(residual_accumulator)
            first_layer = downblock[0]
            assert hasattr(first_layer, "out_channels"), f"{first_layer} has no out_channels attribute"
            block_channels = first_layer.out_channels
            downblock.replace(
                residual_accumulator,
                ZeroConvolution(
                    scale=scale,
                    residual_index=residual_accumulator.n,
                    in_channels=block_channels,
                    out_channels=block_channels,
                    device=device,
                    dtype=dtype,
                ),
            )

        middle_block_channels = middle_block.layer(0, ResidualBlock).out_channels
        middle_block.append(
            ZeroConvolution(
                scale=scale,
                residual_index=len(downblocks),
                in_channels=middle_block_channels,
                out_channels=middle_block_channels,
                device=device,
                dtype=dtype,
            )
        )

    @property
    def scale(self) -> float:
        return self.ensure_find(ZeroConvolution).scale

    @scale.setter
    def scale(self, value: float) -> None:
        for zero_convolution_module in self.layers(ZeroConvolution, recurse=True):
            zero_convolution_module.scale = value


class ControlLoraAdapter(Chain, Adapter[SDXLUNet]):
    """Puts a `ControlLora` first in the target SDXLUNet. The ControlLora is
    registered in the UNet while injected, not in the adapter, so the bare
    UNet's keys stay the JAX package's."""

    def __init__(
        self,
        name: str,
        target: SDXLUNet,
        scale: float = 1.0,
        condition_channels: int = 3,
        weights: dict[str, torch.Tensor] | None = None,
    ) -> None:
        with self.setup_adapter(target):
            self.name = name
            # a list keeps torch from registering the ControlLora here
            self._control_lora = [
                ControlLora(name=name, unet=target, scale=scale, condition_channels=condition_channels),
            ]
            super().__init__(target)
        if weights:
            self.load_weights(weights)

    @property
    def control_lora(self) -> ControlLora:
        return self._control_lora[0]

    def init_context(self) -> Contexts:
        return {f"control_lora_{self.name}": {"condition": None}}

    def inject(self, parent: Chain | None = None) -> "ControlLoraAdapter":
        self.target.insert(index=0, module=self.control_lora)
        return super().inject(parent)

    def eject(self) -> None:
        self.target.remove(self.control_lora)
        return super().eject()

    def structural_copy(self) -> "ControlLoraAdapter":
        raise RuntimeError("ControlLoraAdapter cannot be copied, eject it first.")

    @property
    def scale(self) -> float:
        return self.control_lora.scale

    @scale.setter
    def scale(self, value: float) -> None:
        self.control_lora.scale = value

    def set_condition(self, condition: torch.Tensor) -> None:
        """A (B, 3, H, W) condition image in [0, 1], cast to the ControlLora's device and dtype."""
        control_lora = self.control_lora
        condition = condition.to(device=control_lora.device, dtype=control_lora.dtype)
        self.set_context(context=f"control_lora_{self.name}", value={"condition": condition})

    def _cast(self, state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The tensors on the device and in the dtype of the layers the
        ControlLora owns (its condition encoder's): the UNet's, unless the
        UNet is on ``meta`` and only those layers were materialized."""
        encoder = self.control_lora.ensure_find(ConditionEncoder)
        return {
            key: torch.as_tensor(value).to(device=encoder.device, dtype=encoder.dtype)
            for key, value in state_dict.items()
        }

    def load_weights(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Load refiners-layout weights: `ControlLora.*` LoRA pairs,
        `ZeroConvolution_NN.*` and `ConditionEncoder.*`."""
        state_dict = self._cast(state_dict)
        ControlLoraAdapter.load_lora_layers(self.name, state_dict, self.control_lora)
        ControlLoraAdapter.load_zero_convolution_layers(state_dict, self.control_lora)
        ControlLoraAdapter.load_condition_encoder(state_dict, self.control_lora)

    @staticmethod
    def load_lora_layers(name: str, state_dict: dict[str, torch.Tensor], control_lora: ControlLora) -> None:
        """Wrap each layer the `ControlLora.<path>.down`/`.up` keys name in a LoRA."""
        lora_weights = {
            key.removeprefix("ControlLora."): value for key, value in state_dict.items() if "ControlLora" in key
        }
        lora_weights = {f"{key}.weight": value for key, value in lora_weights.items()}
        loras = Lora.from_dict(name, state_dict=lora_weights)

        adapters: list[LoraAdapter] = []
        for key, lora in loras.items():
            target = control_lora.layer(key.split("."), WeightedModule)
            assert lora.is_compatible(target)
            adapters.append(LoraAdapter(target, lora))
        for adapter in adapters:
            adapter.inject(control_lora)

    @staticmethod
    def load_zero_convolution_layers(state_dict: dict[str, torch.Tensor], control_lora: ControlLora) -> None:
        zero_convolution_layers = list(control_lora.layers(ZeroConvolution, recurse=True))
        for i, zero_convolution_layer in enumerate(zero_convolution_layers):
            sub = {
                key.removeprefix(f"ZeroConvolution_{i+1:02d}."): value
                for key, value in state_dict.items()
                if f"ZeroConvolution_{i+1:02d}" in key
            }
            zero_convolution_layer.load_state_dict(sub, strict=False)

    @staticmethod
    def load_condition_encoder(state_dict: dict[str, torch.Tensor], control_lora: ControlLora) -> None:
        condition_encoder_layer = control_lora.ensure_find(ConditionEncoder)
        sub = {
            key.removeprefix("ConditionEncoder."): value
            for key, value in state_dict.items()
            if "ConditionEncoder" in key
        }
        condition_encoder_layer.load_state_dict(sub, strict=False)

    # -- stability-ai's original Control-LoRA format ---------------------------

    @staticmethod
    def sort_original_keys(key: str, /) -> tuple[str, int]:
        """The order in which an original checkpoint's LoRA keys meet the
        ControlLora's layers: the time embedding first, then the label
        embedding, each `proj_out` after its transformer blocks, the rest as
        `SDLoraManager.sort_keys` orders them."""
        if "time_embed" in key:
            return ("", -2)
        if "label_emb" in key:
            return ("", -1)
        if "proj_out" in key:
            return (key.removesuffix("proj_out") + "transformer_blocks.99.ff.net.2", 10)
        return SDLoraManager.sort_keys(key)

    def load_original_weights(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Load an original checkpoint (LDM key names: LoRA `.up`/`.down`
        pairs, `input_hint_block.*`, `zero_convs.*.0`, `middle_block_out.0`).
        The LoRAs attach, in key order, each to the next layer of its shape;
        the convolutions are OIHW already, as the port holds them."""
        state_dict = self._cast(state_dict)
        control_lora = self.control_lora

        lora_weights = {
            f"{key}.weight": value for key, value in state_dict.items() if ".up" in key or ".down" in key
        }
        loras = Lora.from_dict(self.name, state_dict=lora_weights)
        loras = {key: loras[key] for key in sorted(loras.keys(), key=ControlLoraAdapter.sort_original_keys)}
        auto_attach_loras(loras, control_lora, exclude=["ZeroConvolution", "ConditionEncoder"])

        # the condition encoder's convolutions are input_hint_block.{0, 2, 4, ...}
        condition_encoder = control_lora.ensure_find(ConditionEncoder)
        with torch.no_grad():
            for i, (conv, _) in enumerate(condition_encoder.walk(Conv2d, recurse=True)):
                conv.weight.copy_(state_dict[f"input_hint_block.{2 * i}.weight"])
                conv.bias.copy_(state_dict[f"input_hint_block.{2 * i}.bias"])

            # the zero convolutions: zero_convs.{i}.0 for the down blocks, middle_block_out.0 last
            zero_convs = [z.ensure_find(Conv2d) for z in control_lora.layers(ZeroConvolution, recurse=True)]
            num_down = sum(1 for key in state_dict if key.startswith("zero_convs")) // 2
            assert len(zero_convs) == num_down + 1, f"{len(zero_convs)} zero convs vs {num_down} down taps + middle"
            for i, conv in enumerate(zero_convs):
                stem = f"zero_convs.{i}.0" if i < num_down else "middle_block_out.0"
                conv.weight.copy_(state_dict[f"{stem}.weight"])
                conv.bias.copy_(state_dict[f"{stem}.bias"])
