from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import (
    DDIM,
    DDPM,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import SD1UNet
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import (
    DoubleTextEncoder,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_XL,
)

__all__ = [
    "DDIM",
    "DDPM",
    "DoubleTextEncoder",
    "LatentDiffusionAutoencoder",
    "LatentDiffusionModel",
    "ModelPredictionType",
    "NoiseSchedule",
    "SD1UNet",
    "SDXLAutoencoder",
    "SDXLUNet",
    "Solver",
    "SolverParams",
    "StableDiffusion_XL",
    "TimestepSpacing",
]
