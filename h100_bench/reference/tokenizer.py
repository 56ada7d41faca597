"""CLIP's byte-level BPE tokenizer (OpenAI's ``simple_tokenizer``), in plain
Python over the published merge table. The table is the raw file that the
port ships beside its own tokenizer (``bpe_simple_vocab_16e6.txt.gz``); this
module reads it and nothing else of the port.
"""

from __future__ import annotations

import functools
import gzip
import re
from pathlib import Path

VOCAB = Path(__file__).resolve().parents[2] / "refiners_tpu_torch" / "foundationals" / "clip" / "bpe_simple_vocab_16e6.txt.gz"
START, END = 49406, 49407
# the published pattern, restricted to what `\p{L}` and `\p{N}` mean on ASCII text
_PATTERN = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|(?:[^\s\w]|_)+", re.IGNORECASE)


def _bytes_to_unicode() -> dict[int, str]:
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    table, extra = {b: chr(b) for b in keep}, 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class Tokenizer:
    def __init__(self, vocab: Path = VOCAB) -> None:
        with gzip.open(vocab) as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        tokens = list(self.byte_encoder.values())
        tokens += [t + "</w>" for t in tokens] + ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.ranks = {m: i for i, m in enumerate(merges)}

    @functools.lru_cache(maxsize=4096)  # noqa: B019 (one tokenizer a process)
    def bpe(self, word: str) -> tuple[str, ...]:
        parts = tuple(word[:-1]) + (word[-1] + "</w>",)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = tuple(merged)
        return parts

    def __call__(self, text: str, length: int = 77, pad: int = END) -> list[int]:
        """Start, the text's tokens, end, then `pad` up to `length`."""
        ids = []
        for chunk in _PATTERN.findall(re.sub(r"\s+", " ", text.lower()).strip()):
            word = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids += [self.encoder[t] for t in self.bpe(word)]
        ids = [START, *ids[: length - 2], END]
        return ids + [pad] * (length - len(ids))
