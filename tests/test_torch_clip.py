"""The port's CLIP tokenizer and SDXL double text encoder against the JAX
package, on the CPU."""

from __future__ import annotations

from typing import Any

import numpy as np
import pytest
import torch

from refiners_tpu.foundationals.clip.text_encoder import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import (
    DoubleTextEncoder as JaxDoubleTextEncoder,
)
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import DoubleTextEncoder

# float32 on both sides; only the summation order differs
TOL = 1e-5

PROMPTS = [
    "a cute cat",
    "A photo of an astronaut riding a horse, 4k, highly detailed!",
    "Éléphant café 123 — don't  stop_me",
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_tokenizer_ids_equal_jax(prompt: str) -> None:
    for pad in (49407, 0):  # CLIP-L pads with EOT, CLIP-G with 0
        want = np.asarray(JaxCLIPTokenizer(pad_token_id=pad)(prompt))
        got = CLIPTokenizer(pad_token_id=pad)(prompt)
        assert got.shape == (1, 77)
        np.testing.assert_array_equal(got.numpy(), want)


def _double_text_encoders(num_layers: int) -> tuple[Any, DoubleTextEncoder]:
    """CLIP-L and CLIP-G widths, `num_layers` layers each, bridged."""

    def build(encoder: Any, tokenizer: Any, double: Any) -> Any:
        text_l = encoder(embedding_dim=768, num_layers=num_layers, num_attention_heads=12, feedforward_dim=3072, use_quick_gelu=True)
        text_g = encoder(
            embedding_dim=1280, num_layers=num_layers, num_attention_heads=20, feedforward_dim=5120,
            tokenizer=tokenizer(pad_token_id=0),
        )  # fmt: skip
        return double(text_encoder_l=text_l, text_encoder_g=text_g)

    jax_te = build(JaxCLIPTextEncoder, JaxCLIPTokenizer, JaxDoubleTextEncoder)
    port_te = build(CLIPTextEncoder, CLIPTokenizer, DoubleTextEncoder)
    load_jax_state_dict(port_te, {k: np.asarray(v) for k, v in jax_te.state_dict().items()})
    return jax_te, port_te


def test_double_text_encoder_matches_jax() -> None:
    jax_te, port_te = _double_text_encoders(num_layers=2)
    want_emb, want_pooled = jax_te(PROMPTS[:2])
    with torch.no_grad():
        got_emb, got_pooled = port_te(PROMPTS[:2])
    assert got_emb.shape == (2, 77, 2048) and got_pooled.shape == (2, 1280)
    for got, want in ((got_emb, want_emb), (got_pooled, want_pooled)):
        want = np.asarray(want)
        assert float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)) <= TOL
