"""CLIP BPE tokenizer, on the host.

Counterpart of ``refiners_tpu/foundationals/clip/tokenizer.py``: byte-level
BPE over the OpenAI CLIP merge table (``bpe_simple_vocab_16e6.txt.gz``,
shipped beside this file), SOT/EOT wrapping and fixed-length padding. The
merges run in the native C++ engine (``native/bpe.cpp``, built with ``g++``
at first use) where it builds, else in Python; ``engine`` says which. The
output is a (batch, sequence_length) int64 tensor on the CPU; the text
encoder's Converter moves it to the model's device.
"""

from __future__ import annotations

import gzip
import re
from pathlib import Path

import torch

import refiners_tpu_torch.fluxion.layers as fl

DEFAULT_VOCAB = Path(__file__).resolve().parent / "bpe_simple_vocab_16e6.txt.gz"


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2-style reversible byte → printable-unicode map."""
    printable = (
        list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping: dict[int, str] = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


class CLIPTokenizer(fl.Module):
    """Byte-level BPE tokenizer producing (batch, sequence_length) ids."""

    # host-side tables and the merge cache: left out of a compiled program's
    # key (`fluxion.graphs`), as the JAX package leaves them out of its pytree
    _pytree_ignore = frozenset({"_byte_encoder", "_encoder", "_bpe_ranks", "_cache", "_pattern", "_native"})

    def __init__(
        self,
        vocabulary_path: str | Path = DEFAULT_VOCAB,
        sequence_length: int = 77,
        start_of_text_token_id: int = 49406,
        end_of_text_token_id: int = 49407,
        pad_token_id: int = 49407,
    ) -> None:
        super().__init__()
        self.vocabulary_path = str(vocabulary_path)
        self.sequence_length = sequence_length
        self.start_of_text_token_id = start_of_text_token_id
        self.end_of_text_token_id = end_of_text_token_id
        self.pad_token_id = pad_token_id

        self._byte_encoder = _bytes_to_unicode()
        with gzip.open(vocabulary_path) as f:
            raw = f.read().decode("utf-8").split("\n")
        # CLIP vocab file: a header line, then 49152-256-2 merge lines
        merges = [tuple(line.split()) for line in raw[1 : 49152 - 256 - 2 + 1]]
        base = list(self._byte_encoder.values())
        vocab = base + [f"{tok}</w>" for tok in base] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self._encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self._bpe_ranks: dict[tuple[str, ...], int] = {m: i for i, m in enumerate(merges)}
        self._cache: dict[str, list[str]] = {}
        self._pattern = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|(?:[^\s\w]|_)+",
            flags=re.IGNORECASE,
        )
        self._native = None
        try:
            from refiners_tpu_torch.native.bpe_binding import NativeBPE

            byte_decoder = {v: k for k, v in self._byte_encoder.items()}
            self._native = NativeBPE(self._encoder, self._bpe_ranks, byte_decoder)  # type: ignore[arg-type]
        except RuntimeError:
            pass  # no C++ compiler: the Python merges

    @property
    def engine(self) -> str:
        """The merge engine in use: ``"native"`` (C++) or ``"python"``."""
        return "python" if self._native is None else "native"

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word: list[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self._bpe_ranks.get(p, 1 << 30))
            if best not in self._bpe_ranks:
                break
            first, second = best
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode_str(self, text: str) -> list[int]:
        """Text → BPE token ids, without special tokens."""
        text = re.sub(r"\s+", " ", text.lower()).strip()
        chunks = self._pattern.findall(text)
        if self._native is not None and not self._cache:
            # one call of the native engine for the whole prompt
            return self._native.encode_words([c.encode("utf-8") for c in chunks])
        ids: list[int] = []
        for chunk in chunks:
            mapped = "".join(self._byte_encoder[b] for b in chunk.encode("utf-8"))
            if mapped in self._cache:  # includes concept tokens
                ids.extend(self._encoder[sub] for sub in self._cache[mapped])
            elif self._native is not None:
                ids.extend(self._native.encode_word(chunk.encode("utf-8")))
            else:
                ids.extend(self._encoder[sub] for sub in self._bpe(mapped))
        return ids

    def encode(self, text: str, max_length: int | None = None) -> torch.Tensor:
        """SOT + ids + EOT as a 1-D int64 tensor."""
        ids = self.encode_str(text)
        if max_length is not None:
            assert max_length >= 2
            ids = ids[: max_length - 2]
        return torch.tensor([self.start_of_text_token_id, *ids, self.end_of_text_token_id], dtype=torch.int64)

    def tokenize_str(self, text: str) -> torch.Tensor:
        tokens = self.encode(text=text, max_length=self.sequence_length)
        n = tokens.shape[0]
        assert n <= self.sequence_length, f"Text is too long ({len(text)})"
        padded = torch.full((1, self.sequence_length), self.pad_token_id, dtype=torch.int64)
        padded[0, :n] = tokens
        return padded

    def forward(self, text: str | list[str]) -> torch.Tensor:
        if isinstance(text, str):
            return self.tokenize_str(text)
        assert isinstance(text, list), f"Expected type `str` or `list[str]`, got {type(text)}"
        return torch.cat([self.tokenize_str(t) for t in text], dim=0)
