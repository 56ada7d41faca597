from refiners_tpu_torch.foundationals.latent_diffusion.solvers.ddim import DDIM
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.ddpm import DDPM
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)

__all__ = ["DDIM", "DDPM", "ModelPredictionType", "NoiseSchedule", "Solver", "SolverParams", "TimestepSpacing"]
