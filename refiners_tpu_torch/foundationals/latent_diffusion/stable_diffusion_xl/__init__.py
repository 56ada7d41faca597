from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import (
    SDXLAutoencoder,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import DoubleTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

__all__ = ["DoubleTextEncoder", "SDXLAutoencoder", "SDXLUNet", "StableDiffusion_XL"]
