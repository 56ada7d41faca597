from refiners_tpu_torch.solutions.box_segmenter import BoundingBox, BoxSegmenter

__all__ = ["BoundingBox", "BoxSegmenter"]
