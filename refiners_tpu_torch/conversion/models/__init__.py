from refiners_tpu_torch.conversion.models import (
    adapters,
    autoencoder,
    clip_maps,
    clip_text,
    controlnet,
    diffusion_unet,
    registry,
)

__all__ = [
    "adapters",
    "autoencoder",
    "clip_maps",
    "clip_text",
    "controlnet",
    "diffusion_unet",
    "registry",
]
