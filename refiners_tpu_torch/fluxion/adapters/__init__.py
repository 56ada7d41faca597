from refiners_tpu_torch.fluxion.adapters.adapter import Adapter, lookup_top_adapter
from refiners_tpu_torch.fluxion.adapters.lora import (
    Conv2dLora,
    LinearLora,
    Lora,
    LoraAdapter,
    auto_attach_loras,
)

__all__ = [
    "Adapter",
    "lookup_top_adapter",
    "Conv2dLora",
    "LinearLora",
    "Lora",
    "LoraAdapter",
    "auto_attach_loras",
]
