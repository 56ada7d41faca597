"""ComfyUI helper nodes; counterpart of ``comfyui_refiners_tpu/utils.py``."""

from __future__ import annotations

from typing import Any

import torch
from PIL import Image, ImageDraw

from refiners_tpu_torch.fluxion.utils import image_to_tensor, tensor_to_image

BoundingBox = tuple[int, int, int, int]


def comfy_to_image(image: torch.Tensor) -> Image.Image:
    """A ComfyUI ``IMAGE`` of one image, (1, H, W, C) in [0, 1] → PIL."""
    return tensor_to_image(image.permute(0, 3, 1, 2))


def image_to_comfy(image: Image.Image) -> torch.Tensor:
    """PIL → a ComfyUI ``IMAGE``, (1, H, W, C) in [0, 1]."""
    return image_to_tensor(image).permute(0, 2, 3, 1).contiguous()


class DrawBoundingBox:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {
                "image": ("IMAGE", {}),
                "bbox": ("BOUNDING_BOX", {}),
                "color": ("STRING", {"default": "red"}),
                "width": ("INT", {"default": 3}),
            },
        }

    RETURN_TYPES = ("IMAGE",)
    RETURN_NAMES = ("image",)
    DESCRIPTION = "Draw a bounding box on an image."
    CATEGORY = "RefinersTPU/Helpers"
    FUNCTION = "process"

    def process(
        self,
        image: torch.Tensor,
        bbox: BoundingBox,
        color: str,
        width: int,
    ) -> tuple[torch.Tensor]:
        pil_image = comfy_to_image(image)
        draw = ImageDraw.Draw(pil_image)
        draw.rectangle(bbox, outline=color, width=width)
        return (image_to_comfy(pil_image),)


NODE_CLASS_MAPPINGS: dict[str, Any] = {
    "DrawBoundingBox": DrawBoundingBox,
}
