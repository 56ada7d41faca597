"""Textual-inversion concepts for CLIP text encoders; counterpart of
``refiners_tpu/foundationals/clip/concepts.py``.

`ConceptExtender` adds a token to a copy of the tokenizer and a row to the
token embedding for each concept. Injected, the encoder reads the concept's
token in a prompt as its own id, and its embedding from the added rows.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter
from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoder, TokenEncoder
from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer


class EmbeddingExtender(fl.Chain, Adapter[TokenEncoder]):
    """The token embedding with rows added: `old_weight` is the target's
    (shared), `new_weight` the added rows, both under the JAX package's
    keys."""

    def __init__(self, target: TokenEncoder) -> None:
        with self.setup_adapter(target):
            super().__init__(fl.Lambda(func=self.lookup))
        self.old_weight = target.weight
        self.new_weight = torch.nn.Parameter(
            torch.zeros((0, target.weight.shape[1]), device=target.weight.device, dtype=target.weight.dtype)
        )

    def lookup(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, torch.cat([self.old_weight, self.new_weight], dim=0))

    def add_embedding(self, embedding: torch.Tensor) -> None:
        assert embedding.shape == (self.old_weight.shape[1],)
        row = embedding[None].to(device=self.new_weight.device, dtype=self.new_weight.dtype)
        self.new_weight = torch.nn.Parameter(torch.cat([self.new_weight.detach(), row], dim=0))

    @property
    def num_embeddings(self) -> int:
        return self.old_weight.shape[0] + self.new_weight.shape[0]


class TokenExtender(fl.Chain, Adapter[CLIPTokenizer]):
    """A copy of the tokenizer that also knows the added tokens."""

    def __init__(self, target: CLIPTokenizer) -> None:
        with self.setup_adapter(target):
            super().__init__(
                CLIPTokenizer(
                    vocabulary_path=target.vocabulary_path,
                    sequence_length=target.sequence_length,
                    start_of_text_token_id=target.start_of_text_token_id,
                    end_of_text_token_id=target.end_of_text_token_id,
                    pad_token_id=target.pad_token_id,
                )
            )

    def add_token(self, token: str, token_id: int) -> None:
        token = token.lower()
        tokenizer = self.ensure_find(CLIPTokenizer)
        assert token_id not in tokenizer._encoder.values()
        tokenizer._encoder[token] = token_id
        tokenizer._pattern = re.compile(re.escape(token) + "|" + tokenizer._pattern.pattern, re.IGNORECASE)
        # the concept's token is its own only subtoken, before and after the byte mapping
        tokenizer._cache[token] = [token]
        mapped = "".join(tokenizer._byte_encoder[b] for b in token.encode("utf-8"))
        tokenizer._cache[mapped] = [token]


class ConceptExtender(fl.Chain, Adapter[CLIPTextEncoder]):
    """Extends a CLIP text encoder's vocabulary with textual-inversion
    concepts. Inject to activate; concepts may be added at any time. The
    extenders and the parents they inject into are kept out of the
    adapter's registration (lists)."""

    def __init__(self, target: CLIPTextEncoder) -> None:
        with self.setup_adapter(target):
            super().__init__(target)

        self._ensure_no_nesting()

        try:
            token_encoder, token_encoder_parent = next(target.walk(TokenEncoder))
            self._token_encoder_parent = [token_encoder_parent]
        except StopIteration:
            raise RuntimeError("TokenEncoder not found.")

        try:
            clip_tokenizer, clip_tokenizer_parent = next(target.walk(CLIPTokenizer))
            self._clip_tokenizer_parent = [clip_tokenizer_parent]
        except StopIteration:
            raise RuntimeError("Tokenizer not found.")

        self._embedding_extender = [EmbeddingExtender(token_encoder)]
        self._token_extender = [TokenExtender(clip_tokenizer)]

    def _ensure_no_nesting(self) -> None:
        assert not isinstance(
            self.target.parent, ConceptExtender
        ), "ConceptExtender cannot be nested, add concepts to the injected instance instead."

    @property
    def embedding_extender(self) -> EmbeddingExtender:
        return self._embedding_extender[0]

    @property
    def token_extender(self) -> TokenExtender:
        return self._token_extender[0]

    @property
    def token_encoder_parent(self) -> fl.Chain:
        return self._token_encoder_parent[0]

    @property
    def clip_tokenizer_parent(self) -> fl.Chain:
        return self._clip_tokenizer_parent[0]

    def add_concept(self, token: str, embedding: torch.Tensor) -> None:
        self.embedding_extender.add_embedding(embedding)
        self.token_extender.add_token(token, self.embedding_extender.num_embeddings - 1)

    def inject(self: "ConceptExtender", parent: fl.Chain | None = None) -> "ConceptExtender":
        self._ensure_no_nesting()
        self.embedding_extender.inject(self.token_encoder_parent)
        self.token_extender.inject(self.clip_tokenizer_parent)
        return super().inject(parent)

    def eject(self) -> None:
        self.embedding_extender.eject()
        self.token_extender.eject()
        super().eject()
