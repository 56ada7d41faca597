"""The JAX → port weight bridge, and what importing and running the port on
the CPU must not do (import JAX or Triton, build or load a CUDA library)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable

import numpy as np
import pytest
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.foundationals.clip.text_encoder import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu.foundationals.latent_diffusion import DoubleTextEncoder as JaxDoubleTextEncoder
from refiners_tpu.foundationals.latent_diffusion import SDXLAutoencoder as JaxSDXLAutoencoder
from refiners_tpu.foundationals.latent_diffusion import SDXLUNet as JaxSDXLUNet
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import DoubleTextEncoder, SDXLAutoencoder, SDXLUNet

REPO = Path(__file__).resolve().parents[1]


def _text_encoder(encoder: Any, tokenizer: Any, double: Any) -> Any:
    """The SDXL text encoder's full structure at two layers and a small vocabulary."""
    small = dict(num_layers=2, vocabulary_size=1000)
    text_l = encoder(embedding_dim=768, num_attention_heads=12, feedforward_dim=3072, use_quick_gelu=True, **small)
    text_g = encoder(
        embedding_dim=1280, num_attention_heads=20, feedforward_dim=5120, tokenizer=tokenizer(pad_token_id=0), **small
    )
    return double(text_encoder_l=text_l, text_encoder_g=text_g)


MODELS: dict[str, tuple[Callable[[], Any], Callable[[], torch.nn.Module]]] = {
    "unet": (lambda: JaxSDXLUNet(in_channels=4, base_channels=32), lambda: SDXLUNet(in_channels=4, base_channels=32)),
    "text_encoder": (
        lambda: _text_encoder(JaxCLIPTextEncoder, JaxCLIPTokenizer, JaxDoubleTextEncoder),
        lambda: _text_encoder(CLIPTextEncoder, CLIPTokenizer, DoubleTextEncoder),
    ),
    "vae": (JaxSDXLAutoencoder, SDXLAutoencoder),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_every_jax_key_maps_onto_the_port(model: str) -> None:
    build_jax, build_port = MODELS[model]
    jax_state = {k: np.asarray(v) for k, v in build_jax().state_dict().items()}
    port = build_port()
    assert list(port.state_dict()) == list(jax_state)
    load_jax_state_dict(port, jax_state, strict=True)
    linears = {f"{name}.weight" for name, m in port.named_modules(remove_duplicate=False) if isinstance(m, fl.Linear)}
    for key, value in port.state_dict().items():
        want = jax_state[key]
        if key in linears:
            want = want.T  # Linear (in, out) → (out, in); embeddings keep their layout
        elif value.ndim == 4:
            want = want.transpose(3, 2, 0, 1)  # Conv2d HWIO → OIHW
        np.testing.assert_array_equal(value.numpy(), want, err_msg=key)


def test_bridge_rejects_missing_and_unexpected_keys() -> None:
    jax_state = {k: np.asarray(v) for k, v in JaxSDXLUNet(in_channels=4, base_channels=32).state_dict().items()}
    port = SDXLUNet(in_channels=4, base_channels=32)
    missing = dict(jax_state)
    missing.pop(next(iter(missing)))
    with pytest.raises(KeyError, match="missing"):
        load_jax_state_dict(port, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state_dict(port, {**jax_state, "Extra.weight": np.zeros(3, np.float32)})
    key = next(iter(jax_state))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_state_dict(port, {**jax_state, key: np.zeros((1, 2, 3, 4), np.float32)})


_CPU_SLICE = """
import json, sys
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTokenizer
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM, DoubleTextEncoder, SDXLUNet, StableDiffusion_XL,
)
from refiners_tpu_torch.ops import build
from refiners_tpu_torch.pipelines import TextToImage

small = dict(num_layers=1, feedforward_dim=64)
text_l = CLIPTextEncoder(embedding_dim=768, num_attention_heads=12, use_quick_gelu=True, **small)
text_g = CLIPTextEncoder(embedding_dim=1280, num_attention_heads=20, tokenizer=CLIPTokenizer(pad_token_id=0), **small)
sd = StableDiffusion_XL(
    unet=SDXLUNet(in_channels=4, base_channels=32),
    clip_text_encoder=DoubleTextEncoder(text_encoder_l=text_l, text_encoder_g=text_g),
    solver=DDIM(num_inference_steps=1),
    device="cpu",
)
image = TextToImage(sd, size=(64, 64))("a cat", seed=0)
print(json.dumps({
    "size": list(image.size),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "triton": sorted(m for m in sys.modules if m == "triton" or m.startswith("triton.")),
    "refiners_tpu": sorted(m for m in sys.modules if m == "refiners_tpu" or m.startswith("refiners_tpu.")),
    "libraries_loaded": build.load_library.cache_info().currsize,
}))
"""


def test_port_runs_on_cpu_without_jax_triton_or_a_cuda_build() -> None:
    """The CPU slice, end to end in a fresh interpreter: no JAX, no Triton,
    no JAX package, and no CUDA library built or loaded."""
    build_dir = REPO / "build" / "refiners_tpu_torch"
    before = sorted(build_dir.glob("*")) if build_dir.exists() else []
    proc = subprocess.run(
        [sys.executable, "-c", _CPU_SLICE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"size": [64, 64], "jax": [], "triton": [], "refiners_tpu": [], "libraries_loaded": 0}
    after = sorted(build_dir.glob("*")) if build_dir.exists() else []
    assert after == before
