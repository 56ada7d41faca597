"""Functional ops behind the fluxion layers: the plain attention math path and
the hand-written CUDA kernels with their plain versions."""

from refiners_tpu_torch.ops.attention import dot_product_attention, scaled_dot_product_attention
from refiners_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_packed_plain
from refiners_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_plain

__all__ = [
    "dot_product_attention",
    "flash_attention_packed",
    "flash_attention_packed_plain",
    "group_norm_silu",
    "group_norm_silu_plain",
    "scaled_dot_product_attention",
]
