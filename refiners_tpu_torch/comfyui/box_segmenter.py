"""ComfyUI BoxSegmenter nodes; counterpart of ``comfyui_refiners_tpu/box_segmenter.py``."""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.comfyui.utils import comfy_to_image
from refiners_tpu_torch.fluxion.utils import image_to_tensor
from refiners_tpu_torch.solutions import BoxSegmenter as _BoxSegmenter
from refiners_tpu_torch.solutions.box_segmenter import BoundingBox


class LoadBoxSegmenter:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {
                "checkpoint": ("PATH", {}),
                "margin": ("FLOAT", {"default": 0.05, "min": 0.0, "max": 1.0, "step": 0.01}),
                "device": ("STRING", {"default": "cuda"}),
            }
        }

    RETURN_TYPES = ("MODEL",)
    RETURN_NAMES = ("model",)
    DESCRIPTION = "Load a BoxSegmenter refiners-tpu model."
    CATEGORY = "RefinersTPU/Solutions"
    FUNCTION = "load"

    def load(self, checkpoint: str, margin: float, device: str) -> tuple[_BoxSegmenter]:
        """`checkpoint`: a safetensors file in the port's layout."""
        return (_BoxSegmenter(weights=checkpoint, margin=margin, device=device),)


class BoxSegmenter:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {
                "model": ("MODEL", {}),
                "image": ("IMAGE", {}),
            },
            "optional": {
                "bbox": ("BOUNDING_BOX", {}),
            },
        }

    RETURN_TYPES = ("MASK",)
    RETURN_NAMES = ("mask",)
    DESCRIPTION = "Segment an image using a BoxSegmenter model and a bbox."
    CATEGORY = "RefinersTPU/Solutions"
    FUNCTION = "process"

    def process(
        self,
        model: _BoxSegmenter,
        image: torch.Tensor,
        bbox: BoundingBox | None = None,
    ) -> tuple[torch.Tensor]:
        mask = model(img=comfy_to_image(image), box_prompt=bbox)
        return (image_to_tensor(mask)[:, 0],)  # (1, H, W)


NODE_CLASS_MAPPINGS: dict[str, Any] = {
    "BoxSegmenter": BoxSegmenter,
    "LoadBoxSegmenter": LoadBoxSegmenter,
}
