from refiners_tpu_torch.foundationals.latent_diffusion.auto_encoder import LatentDiffusionAutoencoder
from refiners_tpu_torch.foundationals.latent_diffusion.ella_adapter import ELLA, ELLAAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.freeu import SDFreeUAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.lora import SDLoraManager
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.multi_diffusion import DiffusionTarget, MultiDiffusion
from refiners_tpu_torch.foundationals.latent_diffusion.reference_only_control import ReferenceOnlyControlAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.restart import Restart
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
    Controlnet,
    SD1Autoencoder,
    SD1ControlnetAdapter,
    SD1ELLAAdapter,
    SD1IPAdapter,
    SD1T2IAdapter,
    SD1UNet,
    StableDiffusion_1,
    StableDiffusion_1_Inpainting,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl import (
    ControlLoraAdapter,
    DoubleTextEncoder,
    SDXLAutoencoder,
    SDXLIPAdapter,
    SDXLLcmAdapter,
    SDXLT2IAdapter,
    SDXLUNet,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.style_aligned import StyleAlignedAdapter
from refiners_tpu_torch.foundationals.latent_diffusion.t2i_adapter import T2IAdapter, T2IFeatures

__all__ = [
    "BaseSolverParams",
    "ControlLoraAdapter",
    "Controlnet",
    "DDIM",
    "DDPM",
    "DPMSolver",
    "DiffusionTarget",
    "DoubleTextEncoder",
    "ELLA",
    "ELLAAdapter",
    "Euler",
    "FrankenSolver",
    "LCMSolver",
    "LatentDiffusionAutoencoder",
    "LatentDiffusionModel",
    "ModelPredictionType",
    "MultiDiffusion",
    "NoiseSchedule",
    "ReferenceOnlyControlAdapter",
    "Restart",
    "SD1Autoencoder",
    "SD1ControlnetAdapter",
    "SD1ELLAAdapter",
    "SD1IPAdapter",
    "SD1T2IAdapter",
    "SD1UNet",
    "SDFreeUAdapter",
    "SDLoraManager",
    "SDXLAutoencoder",
    "SDXLIPAdapter",
    "SDXLLcmAdapter",
    "SDXLT2IAdapter",
    "SDXLUNet",
    "Solver",
    "SolverParams",
    "StableDiffusion_1",
    "StableDiffusion_1_Inpainting",
    "StableDiffusion_XL",
    "StyleAlignedAdapter",
    "T2IAdapter",
    "T2IFeatures",
    "TimestepSpacing",
]
