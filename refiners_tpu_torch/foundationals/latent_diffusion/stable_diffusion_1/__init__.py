from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import (
    SD1Autoencoder,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet

__all__ = ["SD1Autoencoder", "SD1UNet", "StableDiffusion_1", "StableDiffusion_1_Inpainting"]
