"""ComfyUI custom nodes for refiners_tpu_torch; counterpart of
``comfyui_refiners_tpu/``, with the same node names.

ComfyUI's ``IMAGE`` is a torch tensor (B, H, W, C) in [0, 1]; the port's
images are NCHW, so the nodes permute on the way in and back on the way
out. A ``MASK`` is (B, H, W).
"""

from typing import Any

from refiners_tpu_torch.comfyui.box_segmenter import NODE_CLASS_MAPPINGS as BOX_SEGMENTER_NODES
from refiners_tpu_torch.comfyui.grounding_dino import NODE_CLASS_MAPPINGS as GROUNDING_DINO_NODES
from refiners_tpu_torch.comfyui.huggingface import HfHubDownload
from refiners_tpu_torch.comfyui.utils import NODE_CLASS_MAPPINGS as UTILS_NODES

NODE_CLASS_MAPPINGS: dict[str, Any] = {
    **BOX_SEGMENTER_NODES,
    **GROUNDING_DINO_NODES,
    **UTILS_NODES,
    "HfHubDownload": HfHubDownload,
}

__all__ = ["NODE_CLASS_MAPPINGS"]
