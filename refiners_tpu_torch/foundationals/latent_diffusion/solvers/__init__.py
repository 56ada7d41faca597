from refiners_tpu_torch.foundationals.latent_diffusion.solvers.ddim import DDIM
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.ddpm import DDPM
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.dpm import DPMSolver
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.euler import Euler
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.franken import FrankenSolver
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.lcm import LCMSolver
from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import (
    BaseSolverParams,
    ModelPredictionType,
    NoiseSchedule,
    Solver,
    SolverParams,
    TimestepSpacing,
)

__all__ = [
    "DDIM",
    "DDPM",
    "DPMSolver",
    "Euler",
    "FrankenSolver",
    "LCMSolver",
    "BaseSolverParams",
    "ModelPredictionType",
    "NoiseSchedule",
    "Solver",
    "SolverParams",
    "TimestepSpacing",
]
