from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.controlnet import (
    Controlnet,
    SD1ControlnetAdapter,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.ella_adapter import SD1ELLAAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.ic_light import ICLight
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.image_prompt import SD1IPAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import (
    SD1Autoencoder,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.multi_diffusion import (
    SD1DiffusionTarget,
    SD1MultiDiffusion,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.multi_upscaler import (
    MultiUpscaler,
    UpscalerCheckpoints,
    UpscalerTarget,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.self_attention_guidance import SD1SAGAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.t2i_adapter import SD1T2IAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.unet import SD1UNet

__all__ = [
    "Controlnet",
    "ICLight",
    "MultiUpscaler",
    "SD1Autoencoder",
    "SD1ControlnetAdapter",
    "SD1DiffusionTarget",
    "SD1ELLAAdapter",
    "SD1IPAdapter",
    "SD1MultiDiffusion",
    "SD1SAGAdapter",
    "SD1T2IAdapter",
    "SD1UNet",
    "StableDiffusion_1",
    "StableDiffusion_1_Inpainting",
    "UpscalerCheckpoints",
    "UpscalerTarget",
]
