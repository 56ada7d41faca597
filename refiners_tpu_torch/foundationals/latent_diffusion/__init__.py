from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import (
    DDIM,
    DDPM,
    BaseSolverParams,
    DPMSolver,
    Euler,
    FrankenSolver,
    LCMSolver,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1 import (
    SD1Autoencoder,
    SD1UNet,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import (
    DoubleTextEncoder,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_XL,
)

__all__ = [
    "BaseSolverParams",
    "DDIM",
    "DDPM",
    "DPMSolver",
    "DoubleTextEncoder",
    "Euler",
    "FrankenSolver",
    "LCMSolver",
    "LatentDiffusionAutoencoder",
    "LatentDiffusionModel",
    "ModelPredictionType",
    "NoiseSchedule",
    "SD1Autoencoder",
    "SD1UNet",
    "SDXLAutoencoder",
    "SDXLUNet",
    "Solver",
    "SolverParams",
    "StableDiffusion_1",
    "StableDiffusion_1_Inpainting",
    "StableDiffusion_XL",
    "TimestepSpacing",
]
