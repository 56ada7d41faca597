"""HuggingFace Hub download node; counterpart of ``comfyui_refiners_tpu/huggingface.py``.

`huggingface_hub` is imported only when the node downloads.
"""

from pathlib import Path
from typing import Any


class HfHubDownload:
    @classmethod
    def INPUT_TYPES(cls) -> dict[str, Any]:
        return {
            "required": {"repo_id": ("STRING", {})},
            "optional": {
                "filename": ("STRING", {}),
                "revision": ("STRING", {"default": "main"}),
            },
        }

    RETURN_TYPES = ("PATH",)
    RETURN_NAMES = ("path",)
    DESCRIPTION = "Download file(s) from the HuggingFace Hub."
    CATEGORY = "RefinersTPU/HuggingFace"
    FUNCTION = "download"

    def download(self, repo_id: str, filename: str = "", revision: str = "main") -> tuple[str]:
        from huggingface_hub import hf_hub_download, snapshot_download  # type: ignore[import-not-found]

        if filename:
            path = hf_hub_download(repo_id=repo_id, filename=filename, revision=revision)
        else:
            path = snapshot_download(repo_id=repo_id, revision=revision)
        return (str(Path(path)),)
