from refiners_tpu_torch.foundationals.clip.text_encoder import (
    CLIPTextEncoder,
    CLIPTextEncoderG,
    CLIPTextEncoderL,
)
from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer

__all__ = ["CLIPTextEncoder", "CLIPTextEncoderG", "CLIPTextEncoderL", "CLIPTokenizer"]
