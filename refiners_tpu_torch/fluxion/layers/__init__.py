"""The `fl` namespace: the fluxion layers of the port."""

from refiners_tpu_torch.fluxion.layers.activations import GLU, Activation, GeLU, GeLUApproximation, ReLU, SiLU
from refiners_tpu_torch.fluxion.layers.attentions import (
    Attention,
    ScaledDotProductAttention,
    SelfAttention,
    SelfAttention2d,
)
from refiners_tpu_torch.fluxion.layers.basics import (
    Cos,
    Flatten,
    Identity,
    Multiply,
    Parameter,
    Permute,
    Reshape,
    Sin,
    Slicing,
    Squeeze,
    Transpose,
    Unflatten,
    Unsqueeze,
)
from refiners_tpu_torch.fluxion.layers.chain import (
    Chain,
    ChainError,
    Concatenate,
    Distribute,
    Lambda,
    Matmul,
    Parallel,
    Passthrough,
    Residual,
    SetContext,
    Sum,
    UseContext,
)
from refiners_tpu_torch.fluxion.layers.conv import Conv2d, ConvTranspose2d
from refiners_tpu_torch.fluxion.layers.converter import Converter
from refiners_tpu_torch.fluxion.layers.embedding import Embedding
from refiners_tpu_torch.fluxion.layers.linear import Linear, MultiLinear
from refiners_tpu_torch.fluxion.layers.module import ContextModule, Module, ModuleTree, WeightedModule
from refiners_tpu_torch.fluxion.layers.norm import GroupNorm, LayerNorm, LayerNorm2d
from refiners_tpu_torch.fluxion.layers.sampling import Downsample, Interpolate, Upsample

__all__ = [
    "Activation",
    "GLU",
    "GeLU",
    "GeLUApproximation",
    "ReLU",
    "SiLU",
    "Attention",
    "ScaledDotProductAttention",
    "SelfAttention",
    "SelfAttention2d",
    "Cos",
    "Flatten",
    "Identity",
    "Multiply",
    "Parameter",
    "Permute",
    "Reshape",
    "Sin",
    "Slicing",
    "Squeeze",
    "Transpose",
    "Unflatten",
    "Unsqueeze",
    "Chain",
    "ChainError",
    "Concatenate",
    "Distribute",
    "Lambda",
    "Matmul",
    "Parallel",
    "Passthrough",
    "Residual",
    "SetContext",
    "Sum",
    "UseContext",
    "Conv2d",
    "ConvTranspose2d",
    "Converter",
    "Embedding",
    "Linear",
    "MultiLinear",
    "ContextModule",
    "Module",
    "ModuleTree",
    "WeightedModule",
    "GroupNorm",
    "LayerNorm",
    "LayerNorm2d",
    "Downsample",
    "Interpolate",
    "Upsample",
]
