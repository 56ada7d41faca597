"""CLIP-H, the public names, the fluxion accessors and SDXL's structural copy
against the JAX package, on the CPU.

`CLIPTextEncoderH` at full width on the meta device against the JAX class's
shapes (`jax.eval_shape`, no memory), and at its widths with 2 layers on
bridged weights; the `__all__` lists of `fluxion`, `foundationals.clip` and
`foundationals.latent_diffusion`, read with `ast` from both trees;
`Chain.keys/values/items`, `Module.param_count` and `Module.pretty_print` on
`tests/fluxion/test_module.py`'s chain, a reduced `SD1UNet` and the reduced
CLIP-H; `PositionalEncoder.position_ids`; `StableDiffusion_XL.structural_copy`
on a reduced SDXL (one-layer CLIP-L/G at their widths, reduced UNet, the VAE
stubbed). Float32 on both sides: `tests/test_torch_clip.py`'s TOL.
"""

from __future__ import annotations

import ast
import contextlib
import io
from pathlib import Path
from typing import Any

import jax
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.foundationals.clip import CLIPTextEncoder as JaxCLIPTextEncoder
from refiners_tpu.foundationals.clip import CLIPTextEncoderG as JaxCLIPTextEncoderG
from refiners_tpu.foundationals.clip import CLIPTextEncoderH as JaxCLIPTextEncoderH
from refiners_tpu.foundationals.clip import CLIPTokenizer as JaxCLIPTokenizer
from refiners_tpu.foundationals.latent_diffusion import DoubleTextEncoder as JaxDoubleTextEncoder
from refiners_tpu.foundationals.latent_diffusion import SD1UNet as JaxSD1UNet
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.conversion.jax_bridge import _weight_layouts
from refiners_tpu_torch.foundationals.clip import CLIPTextEncoder, CLIPTextEncoderH, CLIPTokenizer
from refiners_tpu_torch.foundationals.clip.common import PositionalEncoder
from refiners_tpu_torch.foundationals.latent_diffusion import (
    DDIM,
    DoubleTextEncoder,
    SD1UNet,
    SDXLUNet,
    StableDiffusion_XL,
)
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import TextEncoderWithPooling

TOL = 1e-5  # tests/test_torch_clip.py: float32, only the summation order differs
ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ["a cute cat", "A photo of an astronaut riding a horse, 4k, highly detailed!"]
CLIP_H = {"embedding_dim": 1024, "num_attention_heads": 16, "feedforward_dim": 4096}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridge(port: Any, jax_module: Any) -> None:
    load_jax_state_dict(port, {k: np.asarray(v) for k, v in jax_module.state_dict().items()})


# -- CLIP-H ------------------------------------------------------------------


def test_clip_text_encoder_h_on_meta() -> None:
    """Full width: the JAX class's keys, and its shapes in the port's layout."""
    want = jax.eval_shape(lambda: JaxCLIPTextEncoderH().state_dict())
    encoder = CLIPTextEncoderH(device="meta")
    assert encoder.device == torch.device("meta") and encoder.num_layers == 23
    layouts = _weight_layouts(encoder)
    got = encoder.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        shape = tuple(value.shape[i] for i in layouts[key]) if key in layouts else tuple(value.shape)
        assert tuple(got[key].shape) == shape, key
    assert encoder.param_count() == sum(int(np.prod(v.shape)) for v in want.values())
    assert not any(isinstance(m, fl.GeLU) and m.approximation != fl.GeLUApproximation.NONE for m in encoder.modules())


def test_clip_text_encoder_h_defaults_to_the_card() -> None:
    """A facade: with no device it builds on `cuda`, which raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("the card is present: phase 15c of chip_smoke.py builds it there")
    with pytest.raises((RuntimeError, AssertionError)):
        CLIPTextEncoderH()


@pytest.fixture(scope="module")
def clip_h() -> tuple[Any, CLIPTextEncoder]:
    """CLIP-H's widths and plain GeLU, 2 layers, bridged."""
    jax_encoder = JaxCLIPTextEncoder(num_layers=2, **CLIP_H)
    encoder = CLIPTextEncoder(num_layers=2, **CLIP_H)
    _bridge(encoder, jax_encoder)
    return jax_encoder, encoder


def test_reduced_clip_h_matches_jax(clip_h: tuple[Any, CLIPTextEncoder]) -> None:
    jax_encoder, encoder = clip_h
    want = np.asarray(jax_encoder(PROMPTS))
    with torch.no_grad():
        got = encoder(PROMPTS).numpy()
    assert got.shape == want.shape == (2, 77, 1024)
    assert _rel(got, want) <= TOL


# -- public names ------------------------------------------------------------


def _all(package_dir: Path) -> list[str]:
    tree = ast.parse((package_dir / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return sorted(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {package_dir}")


@pytest.mark.parametrize("package", ["fluxion", "foundationals/clip", "foundationals/latent_diffusion"])
def test_export_list_matches_jax(package: str) -> None:
    want = _all(ROOT / "refiners_tpu" / package)
    assert _all(ROOT / "refiners_tpu_torch" / package) == want
    module = __import__("refiners_tpu_torch." + package.replace("/", "."), fromlist=["__all__"])
    assert all(hasattr(module, name) for name in want)


# -- fluxion accessors ---------------------------------------------------------


def _test_module_chain(ns: Any) -> Any:
    """tests/fluxion/test_module.py's chains, in one."""
    return ns.Chain(ns.Sum(ns.Linear(1, 1), ns.Linear(1, 1)), ns.Sum(), ns.Linear(2, 3), ns.Chain(ns.SiLU()))


def _chains(name: str) -> tuple[Any, Any]:
    if name == "test_module_chain":
        return _test_module_chain(jfl), _test_module_chain(fl)
    return JaxSD1UNet(in_channels=4, base_channels=32), SD1UNet(in_channels=4, base_channels=32)


@pytest.mark.parametrize("name", ["test_module_chain", "sd1_unet"])
def test_chain_accessors_and_param_count_match_jax(name: str) -> None:
    jax_chain, chain = _chains(name)
    assert list(chain.keys()) == list(jax_chain.keys())
    assert [type(m).__name__ for m in chain.values()] == [type(m).__name__ for m in jax_chain.values()]
    assert [(k, type(m).__name__) for k, m in chain.items()] == [(k, type(m).__name__) for k, m in jax_chain.items()]
    assert all(m is chain[k] for k, m in chain.items())
    assert chain.param_count() == jax_chain.param_count()
    assert chain.param_count() == sum(p.numel() for p in chain.parameters())


def _printed(module: Any, depth: int = -1) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.pretty_print(depth)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("depth", [-1, 1])
def test_pretty_print_matches_jax(depth: int, clip_h: tuple[Any, CLIPTextEncoder]) -> None:
    """The same tree lines. The one difference: the tokenizer's vocabulary
    path names the package the file lies in."""
    jax_chain, chain = _chains("test_module_chain")
    assert _printed(chain, depth) == _printed(jax_chain, depth)
    jax_encoder, encoder = clip_h
    want = [line.replace("/refiners_tpu/", "/refiners_tpu_torch/") for line in _printed(jax_encoder, depth)]
    got = _printed(encoder, depth)
    assert got == want
    assert len(got) == (49 if depth == -1 else 7) and "SiLU" not in "".join(_printed(encoder, 0))


def test_position_ids(clip_h: tuple[Any, CLIPTextEncoder]) -> None:
    jax_encoder, encoder = clip_h
    import refiners_tpu.foundationals.clip.common as jax_common

    want = np.asarray(jax_encoder.ensure_find(jax_common.PositionalEncoder).position_ids)
    got = encoder.ensure_find(PositionalEncoder).position_ids
    assert got.shape == (1, 77) and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert PositionalEncoder(max_sequence_length=5, embedding_dim=4, device="meta").position_ids.device.type == "meta"


# -- SDXL's structural copy ----------------------------------------------------


class _JaxReducedG(JaxCLIPTextEncoderG):
    """CLIP-G's widths at one layer: the JAX copy looks CLIP-G up by type."""

    def __init__(self) -> None:
        JaxCLIPTextEncoder.__init__(
            self, embedding_dim=1280, num_layers=1, num_attention_heads=20, feedforward_dim=5120,
            tokenizer=JaxCLIPTokenizer(pad_token_id=0),
        )  # fmt: skip


def _port_text_encoder() -> DoubleTextEncoder:
    text_l = CLIPTextEncoder(embedding_dim=768, num_layers=1, num_attention_heads=12, use_quick_gelu=True)
    text_g = CLIPTextEncoder(
        embedding_dim=1280, num_layers=1, num_attention_heads=20, feedforward_dim=5120,
        tokenizer=CLIPTokenizer(pad_token_id=0),
    )  # fmt: skip
    return DoubleTextEncoder(text_encoder_l=text_l, text_encoder_g=text_g)


@pytest.fixture(scope="module")
def sdxl() -> tuple[Any, StableDiffusion_XL]:
    text_l = JaxCLIPTextEncoder(embedding_dim=768, num_layers=1, num_attention_heads=12, use_quick_gelu=True)
    jax_te = JaxDoubleTextEncoder(text_encoder_l=text_l, text_encoder_g=_JaxReducedG())
    sd = StableDiffusion_XL(
        unet=SDXLUNet(in_channels=4, base_channels=32),
        lda=fl.Chain(fl.Identity()),  # type: ignore[arg-type]
        clip_text_encoder=_port_text_encoder(),
        solver=DDIM(num_inference_steps=2),
        device="cpu",
    )
    # the JAX CLIP-G's keys carry its class name; the port's reduced CLIP-G is a CLIPTextEncoder
    state = {k.replace("_JaxReducedG", "CLIPTextEncoder"): np.asarray(v) for k, v in jax_te.state_dict().items()}
    load_jax_state_dict(sd.clip_text_encoder, state)
    return jax_te, sd


def test_sdxl_structural_copy_embeddings(sdxl: tuple[Any, StableDiffusion_XL]) -> None:
    """The copy's embeddings equal the original's bit for bit, and the JAX copy's within TOL."""
    jax_te, sd = sdxl
    copy = sd.structural_copy()
    assert type(copy) is StableDiffusion_XL and copy.clip_text_encoder is not sd.clip_text_encoder
    with torch.no_grad():
        want = sd.clip_text_encoder(PROMPTS)
        got = copy.clip_text_encoder(PROMPTS)
        again = sd.clip_text_encoder(PROMPTS)
    assert got[0].shape == (2, 77, 2048) and got[1].shape == (2, 1280)
    for g, w, a in zip(got, want, again):
        assert torch.equal(g, w) and torch.equal(a, w)
    jax_got = jax_te.structural_copy()(PROMPTS)
    for g, w in zip(got, jax_got):
        assert _rel(g.numpy(), np.asarray(w)) <= TOL


def test_sdxl_structural_copy_shares_weights_not_contexts(sdxl: tuple[Any, StableDiffusion_XL]) -> None:
    _, sd = sdxl
    copy = sd.structural_copy()
    source_state, copy_state = sd.state_dict(), copy.state_dict()
    assert sorted(copy_state) == sorted(source_state)
    assert all(copy_state[k].data_ptr() == v.data_ptr() for k, v in source_state.items())
    source_tep = sd.clip_text_encoder.ensure_find(TextEncoderWithPooling)
    copy_tep = copy.clip_text_encoder.ensure_find(TextEncoderWithPooling)
    assert copy_tep is not source_tep and copy_tep.parent is copy.clip_text_encoder.layer("Parallel", fl.Parallel)
    projection = ("Parallel", "Chain", "Linear")
    assert copy_tep.layer(projection, fl.Linear) is source_tep.layer(projection, fl.Linear)
    copy.clip_text_encoder.set_context("text_encoder_pooling", {"end_of_text_index": [3]})
    assert copy_tep.use_context("text_encoder_pooling") == {"end_of_text_index": [3]}
    assert source_tep.use_context("text_encoder_pooling") == {"end_of_text_index": []}
    # the copy copies again (its adapter ejects and re-injects like the source's)
    assert sorted(copy.structural_copy().state_dict()) == sorted(source_state)
