from refiners_tpu_torch.foundationals.segment_anything.hq_sam import HQSAMAdapter
from refiners_tpu_torch.foundationals.segment_anything.image_encoder import SAMViT, SAMViTH
from refiners_tpu_torch.foundationals.segment_anything.mask_decoder import MaskDecoder
from refiners_tpu_torch.foundationals.segment_anything.model import (
    ImageEmbedding,
    SegmentAnything,
    SegmentAnythingH,
)
from refiners_tpu_torch.foundationals.segment_anything.prompt_encoder import MaskEncoder, PointEncoder

__all__ = [
    "HQSAMAdapter",
    "SAMViT",
    "SAMViTH",
    "MaskDecoder",
    "ImageEmbedding",
    "SegmentAnything",
    "SegmentAnythingH",
    "MaskEncoder",
    "PointEncoder",
]
