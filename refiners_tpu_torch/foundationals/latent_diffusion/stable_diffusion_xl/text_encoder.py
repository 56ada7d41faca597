"""SDXL double text encoder (CLIP-L[:-2] ‖ CLIP-G with pooling).

Counterpart of ``refiners_tpu/foundationals/latent_diffusion/stable_diffusion_xl/text_encoder.py``.
"""

from __future__ import annotations

from typing import Any

import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.fluxion.context import Contexts
from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoderG, CLIPTextEncoderL
from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer


class TextEncoderWithPooling(fl.Chain, Adapter[CLIPTextEncoderG]):
    """Wrap CLIP-G to also produce the EOT-pooled projected embedding."""

    def __init__(self, target: CLIPTextEncoderG, projection: fl.Linear | None = None) -> None:
        with self.setup_adapter(target=target):
            tokenizer = target.ensure_find(CLIPTokenizer)
            super().__init__(
                tokenizer,
                fl.SetContext(
                    context="text_encoder_pooling", key="end_of_text_index", callback=self.set_end_of_text_index
                ),
                target[1:-2],
                fl.Parallel(
                    fl.Identity(),
                    fl.Chain(
                        target[-2:],
                        projection
                        or fl.Linear(
                            in_features=1280, out_features=1280, bias=False, device=target.device, dtype=target.dtype
                        ),
                        fl.Lambda(func=self.pool),
                    ),
                ),
            )

    def init_context(self) -> Contexts:
        return {"text_encoder_pooling": {"end_of_text_index": []}}

    @property
    def tokenizer(self) -> CLIPTokenizer:
        return self.ensure_find(CLIPTokenizer)

    def set_end_of_text_index(self, end_of_text_index: list[int], tokens: torch.Tensor) -> None:
        positions = (tokens == self.tokenizer.end_of_text_token_id).int().argmax(dim=1)
        end_of_text_index.extend(int(p) for p in positions)

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        end_of_text_index = self.use_context("text_encoder_pooling").get("end_of_text_index", [])
        assert len(end_of_text_index) == x.shape[0], "End of text index not found."
        return torch.stack([x[i, end_of_text_index[i], :] for i in range(x.shape[0])], dim=0)


class DoubleTextEncoder(fl.Chain):
    """Parallel CLIP-L[:-2] + CLIP-G; concat 768+1280 → 2048, plus the pooled 1280."""

    def __init__(
        self,
        text_encoder_l: CLIPTextEncoderL | None = None,
        text_encoder_g: CLIPTextEncoderG | None = None,
        projection: fl.Linear | None = None,
        device: Any = None,
        dtype: Any = None,
    ) -> None:
        text_encoder_l = text_encoder_l or CLIPTextEncoderL(device=device, dtype=dtype)
        text_encoder_g = text_encoder_g or CLIPTextEncoderG(device=device, dtype=dtype)
        super().__init__(
            fl.Parallel(text_encoder_l[:-2], text_encoder_g),
            fl.Lambda(self.concatenate_embeddings),
        )
        tep = TextEncoderWithPooling(target=text_encoder_g, projection=projection)
        tep.inject(self.layer("Parallel", fl.Parallel))

    def concatenate_embeddings(
        self, text_embedding_l: torch.Tensor, text_embedding_with_pooling: tuple[torch.Tensor, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        text_embedding_g, pooled_text_embedding = text_embedding_with_pooling
        return torch.cat((text_embedding_l, text_embedding_g), dim=-1), pooled_text_embedding

    def structural_copy(self: "DoubleTextEncoder") -> "DoubleTextEncoder":
        """Copy the chains around the same weights. The pooling adapter is a
        Chain adapter, which cannot be copied: eject it, copy, put it back,
        and wrap the copy's CLIP-G in an adapter of its own that shares the
        projection."""
        old_tep = self.ensure_find(TextEncoderWithPooling)
        old_tep.eject()
        copy = super().structural_copy()
        old_tep.inject()

        projection = old_tep.layer(("Parallel", "Chain", "Linear"), fl.Linear)
        parallel = copy.layer("Parallel", fl.Parallel)
        # CLIP-G is the Parallel's second branch (a reduced one need not be a CLIPTextEncoderG)
        new_tep = TextEncoderWithPooling(target=parallel[1], projection=projection)
        new_tep.inject(parallel)
        return copy
