"""ctypes binding for the native BPE merge engine (bpe.cpp)."""

from __future__ import annotations

import ctypes
from typing import Mapping

from refiners_tpu_torch.native.build import load_library

_END = "</w>"


class NativeBPE:
    """Byte-domain BPE: vocab/merges are translated from the tokenizer's
    mapped-unicode domain back to raw bytes before registration."""

    def __init__(
        self,
        encoder: Mapping[str, int],
        ranks: Mapping[tuple[str, str], int],
        byte_decoder: Mapping[str, int],
    ) -> None:
        lib = load_library("bpe")
        if lib is None:
            raise RuntimeError("native BPE unavailable (no C++ toolchain)")
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32]
        lib.bpe_add_merge.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.bpe_encode_batch.restype = ctypes.c_int32
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.bpe_new())

        def to_raw(token: str) -> bytes | None:
            suffix = b""
            if token.endswith(_END):
                token = token[: -len(_END)]
                suffix = _END.encode()
            try:
                return bytes(byte_decoder[ch] for ch in token) + suffix
            except KeyError:
                return None  # special/concept token: handled in Python

        for token, idx in encoder.items():
            raw = to_raw(token)
            if raw is not None:
                lib.bpe_add_token(self._handle, raw, len(raw), idx)
        for (a, b), rank in ranks.items():
            ra, rb = to_raw(a), to_raw(b)
            if ra is not None and rb is not None:
                lib.bpe_add_merge(self._handle, ra, len(ra), rb, len(rb), rank)

        self._buf = (ctypes.c_int32 * 4096)()

    def encode_word(self, word: bytes) -> list[int]:
        n = self._lib.bpe_encode(self._handle, word, len(word), self._buf, 4096)
        ids = list(self._buf[:n])
        if any(i < 0 for i in ids):
            raise KeyError("native BPE produced an unknown token")
        return ids

    def encode_words(self, words: list[bytes]) -> list[int]:
        """One FFI crossing for a whole prompt's word list."""
        data = b"".join(words)
        offsets = (ctypes.c_int32 * (len(words) + 1))()
        pos = 0
        for i, w in enumerate(words):
            offsets[i] = pos
            pos += len(w)
        offsets[len(words)] = pos
        n = self._lib.bpe_encode_batch(self._handle, data, offsets, len(words), self._buf, 4096)
        ids = list(self._buf[:n])
        if any(i < 0 for i in ids):
            raise KeyError("native BPE produced an unknown token")
        return ids

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bpe_free(handle)
