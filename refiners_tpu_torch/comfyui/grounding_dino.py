"""ComfyUI GroundingDINO nodes (text → bounding boxes, through transformers);
counterpart of ``comfyui_refiners_tpu/grounding_dino.py``.

GroundingDINO is not reimplemented (neither is it in the reference, which
delegates to transformers): it runs as a host-side preprocessor, with
`transformers` imported only when a node loads or runs it.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.comfyui.utils import BoundingBox, comfy_to_image


class LoadGroundingDino:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {
                "checkpoint": ("PATH", {}),
                "dtype": ("STRING", {"default": "float32"}),
                "device": ("STRING", {"default": "cuda"}),
            }
        }

    RETURN_TYPES = ("PROCESSOR", "MODEL")
    RETURN_NAMES = ("processor", "model")
    DESCRIPTION = "Load a grounding dino model."
    CATEGORY = "RefinersTPU/Solutions"
    FUNCTION = "load"

    def load(self, checkpoint: str, dtype: str, device: str) -> tuple[Any, Any]:
        from transformers import (  # type: ignore
            GroundingDinoForObjectDetection,
            GroundingDinoProcessor,
        )

        processor = GroundingDinoProcessor.from_pretrained(checkpoint)  # type: ignore
        model = GroundingDinoForObjectDetection.from_pretrained(
            checkpoint, torch_dtype=getattr(torch, dtype)
        )  # type: ignore
        model = model.to(device=device)  # type: ignore
        return (processor, model)


class GroundingDino:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {
                "processor": ("PROCESSOR", {}),
                "model": ("MODEL", {}),
                "image": ("IMAGE", {}),
                "prompt": ("STRING", {}),
                "box_threshold": ("FLOAT", {"default": 0.25, "min": 0.0, "max": 1.0, "step": 0.01}),
                "text_threshold": ("FLOAT", {"default": 0.25, "min": 0.0, "max": 1.0, "step": 0.01}),
            },
        }

    RETURN_TYPES = ("BOUNDING_BOX",)
    RETURN_NAMES = ("bbox",)
    DESCRIPTION = "Detect an object in an image using a GroundingDino model."
    CATEGORY = "RefinersTPU/Solutions"
    FUNCTION = "process"

    def process(
        self,
        processor: Any,
        model: Any,
        image: torch.Tensor,
        prompt: str,
        box_threshold: float,
        text_threshold: float,
    ) -> tuple[BoundingBox]:
        pil_image = comfy_to_image(image)
        inputs = processor(images=pil_image, text=prompt, return_tensors="pt").to(model.device)
        with torch.no_grad():
            outputs = model(**inputs)
        results = processor.post_process_grounded_object_detection(
            outputs,
            inputs["input_ids"],
            threshold=box_threshold,
            text_threshold=text_threshold,
            target_sizes=[(pil_image.height, pil_image.width)],
        )[0]
        assert len(results["boxes"]) > 0, f"no object detected for prompt {prompt!r}"
        # merge all detected boxes into one (the reference's behavior)
        boxes = results["boxes"].round().to(torch.int32)
        x1 = int(boxes[:, 0].min().clamp(0, pil_image.width))
        y1 = int(boxes[:, 1].min().clamp(0, pil_image.height))
        x2 = int(boxes[:, 2].max().clamp(0, pil_image.width))
        y2 = int(boxes[:, 3].max().clamp(0, pil_image.height))
        return ((x1, y1, x2, y2),)


NODE_CLASS_MAPPINGS: dict[str, Any] = {
    "GroundingDino": GroundingDino,
    "LoadGroundingDino": LoadGroundingDino,
}
