from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.solvers import (
    DDIM,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import (
    DoubleTextEncoder,
    SDXLAutoencoder,
    SDXLUNet,
    StableDiffusion_XL,
)

__all__ = [
    "DDIM",
    "DoubleTextEncoder",
    "LatentDiffusionAutoencoder",
    "LatentDiffusionModel",
    "ModelPredictionType",
    "NoiseSchedule",
    "SDXLAutoencoder",
    "SDXLUNet",
    "Solver",
    "SolverParams",
    "StableDiffusion_XL",
    "TimestepSpacing",
]
