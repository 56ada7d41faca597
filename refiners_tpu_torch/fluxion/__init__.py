from refiners_tpu_torch.fluxion.utils import (
    load_from_safetensors,
    manual_seed,
    no_grad,
    norm,
    pad,
    save_to_safetensors,
)

__all__ = [
    "load_from_safetensors",
    "manual_seed",
    "no_grad",
    "norm",
    "pad",
    "save_to_safetensors",
]
