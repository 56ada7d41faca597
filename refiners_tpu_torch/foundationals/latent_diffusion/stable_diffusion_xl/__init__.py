from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.control_lora import (
    ControlLora,
    ControlLoraAdapter,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.image_prompt import SDXLIPAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.lcm import SDXLLcmAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.lcm_lora import add_lcm_lora
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import (
    SDXLAutoencoder,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.multi_diffusion import (
    SDXLMultiDiffusion,
    SDXLTarget,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.self_attention_guidance import SDXLSAGAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.t2i_adapter import SDXLT2IAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import DoubleTextEncoder
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.unet import SDXLUNet

__all__ = [
    "ControlLora",
    "ControlLoraAdapter",
    "SDXLLcmAdapter",
    "add_lcm_lora",
    "SDXLIPAdapter",
    "SDXLAutoencoder",
    "StableDiffusion_XL",
    "SDXLMultiDiffusion",
    "SDXLTarget",
    "SDXLSAGAdapter",
    "SDXLT2IAdapter",
    "DoubleTextEncoder",
    "SDXLUNet",
]
