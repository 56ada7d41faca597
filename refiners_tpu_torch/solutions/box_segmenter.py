"""BoxSegmenter: MVANet behind a box crop, margin and paste; counterpart of
``refiners_tpu/solutions/box_segmenter.py``.

The MVANet forward and its sigmoid are one compiled program
(`fluxion.graphs.Program`), as the JAX package jits them: a CUDA graph on
the card, eager on the CPU. Built with no device, the model lands on the
card (``fluxion.utils.default_device``); CPU use passes ``device="cpu"``.
"""

from __future__ import annotations

from functools import cached_property
from pathlib import Path
from typing import Any

import torch
from PIL import Image

from refiners_tpu_torch.fluxion.graphs import Program
from refiners_tpu_torch.fluxion.utils import default_device, image_to_tensor, normalize, tensor_to_image
from refiners_tpu_torch.foundationals.swin.mvanet import MVANet

BoundingBox = tuple[int, int, int, int]


class BoxSegmenter:
    def __init__(
        self,
        *,
        margin: float = 0.05,
        weights: Path | str | dict[str, torch.Tensor] | None = None,
        device: Any = None,
    ):
        """`weights`: a state dict in the port's layout, or a safetensors file of one."""
        assert margin >= 0
        self.margin = margin
        self.model = MVANet(device=default_device(device)).eval()

        if weights is not None:
            if isinstance(weights, dict):
                self.model.load_state_dict(weights)
            else:
                self.model.load_from_safetensors(weights)

    def __call__(self, img: Image.Image, box_prompt: BoundingBox | None = None) -> Image.Image:
        return self.run(img, box_prompt)

    @cached_property
    def _predict(self) -> Program:
        """The forward and its sigmoid, as one program."""
        return Program(lambda m, x: torch.sigmoid(m(x)), name="BoxSegmenter._predict")

    def add_margin(self, box: BoundingBox) -> BoundingBox:
        x0, y0, x1, y1 = box
        mx = int((x1 - x0) * self.margin)
        my = int((y1 - y0) * self.margin)
        return (x0 - mx, y0 - my, x1 + mx, y1 + my)

    @staticmethod
    def crop_pad(img: Image.Image, box: BoundingBox) -> Image.Image:
        """Crop `box`, black where it leaves the image."""
        img = img.convert("RGB")
        x0, y0, x1, y1 = box
        px0, py0, px1, py1 = (max(0, -x0), max(0, -y0), max(0, x1 - img.width), max(0, y1 - img.height))
        if (px0, py0, px1, py1) == (0, 0, 0, 0):
            return img.crop(box)
        padded = Image.new("RGB", (img.width + px0 + px1, img.height + py0 + py1))
        padded.paste(img, (px0, py0))
        return padded.crop((x0 + px0, y0 + py0, x1 + px0, y1 + py0))

    def predict(self, img: Image.Image) -> Image.Image:
        """The foreground probability of `img` as an `L` image of its size."""
        model = self.model
        in_t = image_to_tensor(img.resize((1024, 1024), Image.Resampling.BILINEAR), device=model.device)
        in_t = normalize(in_t, [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]).to(model.dtype)
        with torch.inference_mode():
            prediction = self._predict(model, in_t)  # (1, 1, 1024, 1024)
        return tensor_to_image(prediction).resize(img.size, Image.Resampling.BILINEAR)

    def run(self, img: Image.Image, box_prompt: BoundingBox | None = None) -> Image.Image:
        """The mask of the object in `box_prompt` (the whole image by default),
        grown by the margin, pasted into an `L` image of `img`'s size."""
        if box_prompt is None:
            box_prompt = (0, 0, img.width, img.height)
        box = self.add_margin(box_prompt)
        cropped = self.crop_pad(img, box)
        prediction = self.predict(cropped)
        out = Image.new("L", (img.width, img.height))
        out.paste(prediction, box)
        return out
