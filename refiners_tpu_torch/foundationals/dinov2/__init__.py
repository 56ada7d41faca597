from refiners_tpu_torch.foundationals.dinov2.dinov2 import (
    DINOv2_base,
    DINOv2_base_reg,
    DINOv2_giant,
    DINOv2_giant_reg,
    DINOv2_large,
    DINOv2_large_reg,
    DINOv2_small,
    DINOv2_small_reg,
    preprocess,
)
from refiners_tpu_torch.foundationals.dinov2.vit import ViT

__all__ = [
    "DINOv2_base",
    "DINOv2_base_reg",
    "DINOv2_giant",
    "DINOv2_giant_reg",
    "DINOv2_large",
    "DINOv2_large_reg",
    "DINOv2_small",
    "DINOv2_small_reg",
    "preprocess",
    "ViT",
]
