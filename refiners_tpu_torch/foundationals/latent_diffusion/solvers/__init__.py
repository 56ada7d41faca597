from refiners_tpu_torch.foundationals.latent_diffusion.solvers.ddim import DDIM
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)

__all__ = ["DDIM", "ModelPredictionType", "NoiseSchedule", "Solver", "SolverParams", "TimestepSpacing"]
