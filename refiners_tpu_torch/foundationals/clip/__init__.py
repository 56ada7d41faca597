from refiners_tpu_torch.foundationals.clip.concepts import ConceptExtender
from refiners_tpu_torch.foundationals.clip.image_encoder import (
    CLIPImageEncoder,
    CLIPImageEncoderG,
    CLIPImageEncoderH,
)
from refiners_tpu_torch.foundationals.clip.text_encoder import (
    CLIPTextEncoder,
    CLIPTextEncoderG,
    CLIPTextEncoderH,
    CLIPTextEncoderL,
)
from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer

__all__ = [
    "ConceptExtender",
    "CLIPImageEncoder",
    "CLIPImageEncoderG",
    "CLIPImageEncoderH",
    "CLIPTextEncoder",
    "CLIPTextEncoderG",
    "CLIPTextEncoderH",
    "CLIPTextEncoderL",
    "CLIPTokenizer",
]
