"""The SegmentAnything facade; counterpart of
``refiners_tpu/foundationals/segment_anything/model.py``.

As the JAX package compiles two programs, one that encodes an image and one
that turns prompts into masks, `_encode_image` and `_predict_masks` are two
compiled programs (`fluxion.graphs.Program`: CUDA graphs on the card, eager
on the CPU), keyed as JAX's jit is: the model, the input shapes, and the
static arguments (`scaled_size`; the type mask as a tuple, `original_size`,
the encoder resolution and `binarize`). The prompt packing stays on the
host. Image embeddings are NCHW, (1, 256, 64, 64); masks keep the public
(N, M, H, W) layout, bool when binarized. The facades build on (or move
their parts to) the card unless `device` says otherwise (``device="cpu"``).

Neither program waits for the card: host data goes up with
``non_blocking=True`` copies before a program runs, and the point type mask
stays on the host (in the key), so `predict_pipelined` can enqueue every
request before it reads any back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
from PIL import Image

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.graphs import Program
from refiners_tpu_torch.fluxion.utils import default_device
from refiners_tpu_torch.foundationals.segment_anything.image_encoder import SAMViT, SAMViTH
from refiners_tpu_torch.foundationals.segment_anything.mask_decoder import MaskDecoder
from refiners_tpu_torch.foundationals.segment_anything.prompt_encoder import MaskEncoder, PointEncoder
from refiners_tpu_torch.foundationals.segment_anything.utils import (
    PIXEL_MEAN,
    PIXEL_STD,
    compute_scaled_size,
    normalize_coordinates,
    postprocess_masks,
    preprocess_image,
)


@dataclass
class ImageEmbedding:
    features: torch.Tensor  # (1, 256, H, W) NCHW
    original_image_size: tuple[int, int]  # (height, width)
    # context values written while encoding that the decoder reads (HQ-SAM's
    # early ViT embedding), carried from one stage to the next
    captured_contexts: dict[str, dict[str, torch.Tensor]] | None = None


# context keys written by the encoder and read by the decoder, per adapter
_CROSS_STAGE_CONTEXTS: tuple[tuple[str, str], ...] = (("hq_sam", "early_vit_embedding"),)


def _root_chain(module: fl.Chain) -> fl.Chain:
    """The top-most chain: an injected adapter (HQSAMAdapter) if there is one,
    whose contexts the two stages read and write."""
    node: fl.Chain = module
    while node.parent is not None:
        node = node.parent
    return node


def _to_device(x: torch.Tensor, device: torch.device | None) -> torch.Tensor:
    """Host → card without waiting for the card's queue (a blocking copy
    synchronizes the stream)."""
    return x.to(device, non_blocking=True)


def _filled(values: tuple[float, ...], device: torch.device | None) -> torch.Tensor:
    """`values` as a float32 vector on `device`, written by fills: no copy
    from host memory, which a capture cannot hold."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)  # `out[i] = v` copies a host scalar tensor up
    return out


@Program
def _encode_image(root: fl.Chain, x: torch.Tensor, scaled_size: tuple[int, int]) -> tuple[torch.Tensor, dict]:
    """Normalize, zero the padding and run the ViT, as one program.

    `x` is the host-resized image in [0, 255] on the square encoder canvas,
    (1, 3, R, R). The normalization runs in float32 on the device; the padded
    region is zeroed after it, as the reference pads after normalizing.
    """
    h, w = scaled_size
    mean = _filled(PIXEL_MEAN, x.device).reshape(1, 3, 1, 1)
    std = _filled(PIXEL_STD, x.device).reshape(1, 3, 1, 1)
    xn = (x.float() - mean) / std
    xn[:, :, h:, :].zero_()  # in place: `= 0.0` copies a host scalar tensor up
    xn[:, :, :, w:].zero_()
    vit = root.ensure_find(SAMViT)
    features = vit(xn.to(vit.dtype))
    captured: dict = {}
    for context, key in _CROSS_STAGE_CONTEXTS:
        store = root.provider.get_context(context)
        if store is not None and store.get(key) is not None:
            captured.setdefault(context, {})[key] = store[key]
    return features, captured


@Program
def _predict_masks(
    root: fl.Chain,
    image_embedding: torch.Tensor,
    coordinates: torch.Tensor,
    type_mask: tuple[tuple[int, ...], ...],
    low_res_mask: torch.Tensor | None,
    captured_contexts: dict,
    original_size: tuple[int, int],
    image_encoder_resolution: int,
    binarize: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize the coordinates, encode the prompts and the mask, decode the
    masks, upsample them and binarize, as one program. The type mask is a
    tuple (in the key): the prompt padding branches on its values on the
    host, so each prompt configuration has its own program."""
    for context, store in captured_contexts.items():
        root.set_context(context, dict(store))
    point_encoder = root.ensure_find(PointEncoder)
    image_embedding_size = root.ensure_find(SAMViT).image_embedding_size
    mask_decoder = root.ensure_find(MaskDecoder)

    coordinates = normalize_coordinates(
        _to_device(coordinates, image_embedding.device), original_size, image_encoder_resolution
    )

    mask_encoder = root.ensure_find(MaskEncoder)
    if low_res_mask is not None:
        mask_embedding = mask_encoder(low_res_mask)
    else:
        mask_embedding = mask_encoder.get_no_mask_dense_embedding(image_embedding_size=image_embedding_size)

    point_encoder.set_type_mask(type_mask=torch.tensor(type_mask, dtype=torch.int32))
    point_embedding = point_encoder(coordinates)
    dense_positional_embedding = point_encoder.get_dense_positional_embedding(image_embedding_size=image_embedding_size)
    mask_decoder.set_image_embedding(image_embedding=image_embedding)
    mask_decoder.set_mask_embedding(mask_embedding=mask_embedding)
    mask_decoder.set_point_embedding(point_embedding=point_embedding)
    mask_decoder.set_dense_positional_embedding(dense_positional_embedding=dense_positional_embedding)
    low_res_masks, iou_predictions = mask_decoder()

    high_res_masks = postprocess_masks(low_res_masks, original_size, image_encoder_resolution)
    if binarize:
        high_res_masks = high_res_masks > SegmentAnything.mask_threshold
    return high_res_masks, iou_predictions, low_res_masks


class SegmentAnything(fl.Chain):
    mask_threshold: float = 0.0

    def __init__(
        self,
        image_encoder: SAMViT,
        point_encoder: PointEncoder,
        mask_encoder: MaskEncoder,
        mask_decoder: MaskDecoder,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        super().__init__(image_encoder, point_encoder, mask_encoder, mask_decoder)
        self.to(device=default_device(device), dtype=dtype)

    @property
    def image_encoder(self) -> SAMViT:
        return self.ensure_find(SAMViT)

    @property
    def point_encoder(self) -> PointEncoder:
        return self.ensure_find(PointEncoder)

    @property
    def mask_encoder(self) -> MaskEncoder:
        return self.ensure_find(MaskEncoder)

    @property
    def mask_decoder(self) -> MaskDecoder:
        return self.ensure_find(MaskDecoder)

    def compute_image_embedding(self, image: Image.Image) -> ImageEmbedding:
        original_size = (image.height, image.width)
        canvas, scaled_size = self._host_preprocess(image)
        features, captured = _encode_image(_root_chain(self), canvas, scaled_size)
        return ImageEmbedding(features=features, original_image_size=original_size, captured_contexts=captured)

    def _host_preprocess(self, image: Image.Image) -> tuple[torch.Tensor, tuple[int, int]]:
        """PIL bilinear resize of the long side to the encoder resolution,
        placed raw ([0, 255] uint8) on the square canvas, (1, 3, R, R) on the
        model's device: one 3 MB upload."""
        res = self.image_encoder_resolution
        scaled_size = compute_scaled_size((image.height, image.width), res)
        h, w = scaled_size
        resized = image.convert("RGB").resize((w, h), resample=Image.Resampling.BILINEAR)
        canvas = np.zeros((1, 3, res, res), dtype=np.uint8)
        canvas[0, :, :h, :w] = np.asarray(resized, dtype=np.uint8).transpose(2, 0, 1)
        return _to_device(torch.from_numpy(canvas), self.device), scaled_size

    def predict(
        self,
        input: Image.Image | ImageEmbedding,
        foreground_points: Sequence[tuple[float, float]] | None = None,
        background_points: Sequence[tuple[float, float]] | None = None,
        box_points: Sequence[Sequence[tuple[float, float]]] | None = None,
        low_res_mask: torch.Tensor | None = None,
        binarize: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Points, boxes and a mask prompt → (masks, iou_predictions,
        low_res_masks). `low_res_mask` is (1, 1, 256, 256)."""
        root = _root_chain(self)
        if isinstance(input, ImageEmbedding):
            original_size = input.original_image_size
            image_embedding = input.features
            captured_contexts = dict(input.captured_contexts or {})
        else:
            original_size = (input.height, input.width)
            canvas, scaled_size = self._host_preprocess(input)
            image_embedding, captured_contexts = _encode_image(root, canvas, scaled_size)

        coordinates, type_mask = self.point_encoder.points_to_tensor(
            foreground_points=foreground_points,
            background_points=background_points,
            box_points=box_points,
        )
        return _predict_masks(
            root,
            image_embedding,
            _to_device(coordinates, image_embedding.device),
            tuple(map(tuple, type_mask.tolist())),
            low_res_mask,
            captured_contexts,
            original_size,
            self.image_encoder_resolution,
            binarize,
        )

    def predict_pipelined(
        self,
        inputs: Sequence[Image.Image | ImageEmbedding],
        prompts: Sequence[dict[str, Any]],
        binarize: bool = True,
    ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Serve many requests: enqueue every request's work on the card
        before reading any result back, then copy each (masks,
        iou_predictions, low_res_masks) to the host, in request order."""
        pending = [
            self.predict(image, binarize=binarize, **prompt) for image, prompt in zip(inputs, prompts, strict=True)
        ]
        return [tuple(t.cpu().numpy() for t in out) for out in pending]  # type: ignore[misc]

    @property
    def image_encoder_resolution(self) -> int:
        w, h = self.image_encoder.image_size
        assert w == h
        return w

    def preprocess_image(self, image: Image.Image) -> torch.Tensor:
        return preprocess_image(image, self.image_encoder_resolution, device=self.device, dtype=self.dtype)

    def normalize(self, coordinates: torch.Tensor, original_size: tuple[int, int]) -> torch.Tensor:
        return normalize_coordinates(coordinates, original_size, self.image_encoder_resolution)

    def postprocess_masks(self, low_res_masks: torch.Tensor, original_size: tuple[int, int]) -> torch.Tensor:
        return postprocess_masks(low_res_masks, original_size, self.image_encoder_resolution)


class SegmentAnythingH(SegmentAnything):
    """SegmentAnything with the ViT-H image encoder."""

    def __init__(
        self,
        image_encoder: SAMViTH | None = None,
        point_encoder: PointEncoder | None = None,
        mask_encoder: MaskEncoder | None = None,
        mask_decoder: MaskDecoder | None = None,
        multimask_output: bool | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        device = default_device(device)
        image_encoder = image_encoder or SAMViTH(device=device, dtype=dtype)
        point_encoder = point_encoder or PointEncoder(device=device, dtype=dtype)
        mask_encoder = mask_encoder or MaskEncoder(device=device, dtype=dtype)
        if mask_decoder:
            assert (
                multimask_output is None or mask_decoder.multimask_output == multimask_output
            ), f"mask_decoder.multimask_output {mask_decoder.multimask_output} != multimask_output ({multimask_output})"
        else:
            mask_decoder = MaskDecoder(
                multimask_output if multimask_output is not None else True, device=device, dtype=dtype
            )
        super().__init__(image_encoder, point_encoder, mask_encoder, mask_decoder, device=device, dtype=dtype)

    @property
    def image_encoder(self) -> SAMViTH:
        return self.ensure_find(SAMViTH)
