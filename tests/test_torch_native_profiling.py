"""The port's native BPE engine and its profiling helpers, on the CPU.

The engine (``refiners_tpu_torch/native/bpe.cpp``, built with ``g++`` under
``build/refiners_tpu_torch/native/``) must give the token ids of the JAX
package's engine and of the port's own Python merges, exactly, on prompts
with punctuation, digits, unicode (through the byte fallback) and long
words. The profiling helpers run on the CPU here: `trace` writes a Chrome
trace, `benchmark` a positive median, `summarize_memory` one entry per card
(none here).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from refiners_tpu.foundationals.clip.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu_torch.fluxion import profiling
from refiners_tpu_torch.foundationals.clip.tokenizer import DEFAULT_VOCAB, CLIPTokenizer
from refiners_tpu_torch.native import build, load_library

PROMPTS = [
    "a photo of a cat",
    "Intricate detail, masterpiece, 4k!! photorealistic, 8k, ultra-detailed",
    "it's a trap: don't go... we'll see, they've said",
    "zxqwjy flurbish contraption 12345",
    "émoji soupçon façade naïve 東京 🐈‍⬛ — «quotes»",
    "pneumonoultramicroscopicsilicovolcanoconiosis supercalifragilisticexpialidocious",
    "antidisestablishmentarianism" * 3,
    "under_score__double   spaces\ttabs\nnewlines",
    "",
]


@pytest.fixture(scope="module")
def tokenizer() -> CLIPTokenizer:
    tok = CLIPTokenizer()
    if tok.engine != "native":
        pytest.fail("the native engine did not build: g++ is expected on this machine")
    return tok


def _python_twin(tok: CLIPTokenizer) -> CLIPTokenizer:
    twin = object.__new__(CLIPTokenizer)
    twin.__dict__ = {**tok.__dict__, "_native": None, "_cache": {}}
    return twin


def test_native_engine_builds_under_build(tokenizer: CLIPTokenizer) -> None:
    path = build.library_path("bpe")
    assert path.exists() and path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-3:] == ("build", "refiners_tpu_torch", "native")
    assert load_library("bpe") is not None


@pytest.mark.parametrize("prompt", PROMPTS)
def test_native_ids_match_jax_and_python(tokenizer: CLIPTokenizer, prompt: str) -> None:
    native = tokenizer.encode_str(prompt)
    python = _python_twin(tokenizer).encode_str(prompt)
    jax_tokenizer = JaxCLIPTokenizer(vocabulary_path=DEFAULT_VOCAB)
    assert jax_tokenizer._native is not None
    assert native == python == jax_tokenizer.encode_str(prompt)
    assert len(native) > 0 or prompt == ""


def test_native_engine_tokenizes_a_batch(tokenizer: CLIPTokenizer) -> None:
    ids = tokenizer(PROMPTS[:4])
    want = torch.cat([_python_twin(tokenizer)(p) for p in PROMPTS[:4]])
    assert ids.dtype == torch.int64 and ids.shape == (4, 77)
    assert torch.equal(ids, want)


def test_cached_words_take_the_per_word_path(tokenizer: CLIPTokenizer) -> None:
    """A word in the cache (as a textual-inversion concept puts it there) is
    read from the cache; the others still go through the engine."""
    tok = object.__new__(CLIPTokenizer)
    tok.__dict__ = {**tokenizer.__dict__, "_cache": {"cat": ["dog</w>"]}}
    got = tok.encode_str("a photo of a cat")
    want = tokenizer.encode_str("a photo of a dog")
    assert got == want


def test_python_engine_without_a_compiler(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr("refiners_tpu_torch.native.bpe_binding.load_library", lambda name: None)
    tok = CLIPTokenizer()
    assert tok.engine == "python" and tok._native is None
    assert tok.encode_str(PROMPTS[1]) == JaxCLIPTokenizer(vocabulary_path=DEFAULT_VOCAB).encode_str(PROMPTS[1])


def test_benchmark_returns_a_positive_median() -> None:
    x = torch.randn(64, 64)
    calls: list[int] = []

    def fn(a: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        calls.append(1)
        return torch.sin(a) @ torch.cos(a).T, {"sum": a.sum()}

    seconds = profiling.benchmark(fn, x, iterations=5, warmup=2)
    assert isinstance(seconds, float) and seconds > 0
    assert len(calls) == 7


def test_trace_writes_a_chrome_trace(tmp_path: Path) -> None:
    log_dir = tmp_path / "trace"
    with profiling.trace(log_dir) as prof:
        torch.randn(128, 128) @ torch.randn(128, 128)
    trace = json.loads((log_dir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_summarize_memory_reports_every_card() -> None:
    summary = profiling.summarize_memory()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(summary) == count
    assert all(isinstance(v, int) and v >= 0 for v in summary.values())
