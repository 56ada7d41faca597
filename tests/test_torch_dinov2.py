"""The port's DINOv2 and its Fréchet distance against the JAX package, on the CPU.

JAX modules are built from a seed and bridged into the port with
`load_jax_state_dict(strict=True)`; images are seeded numpy arrays handed to
both (NHWC to JAX, NCHW to the port). The reduced model is
`ViT(embedding_dim=128, num_layers=2, num_heads=2, patch_size=14)` (d = 64,
DINOv2's head width): at 518² it has 1370 tokens, 1374 with four registers,
the lengths at which every layer takes the flash kernel (K1) on the card.
Here the port runs the plain version; the K1 site is held against the JAX
package's Pallas kernel in its interpreter (`force_flash`). Float32: 1e-4
absolute on the model's outputs (summation order only); bf16 attention 1e-2
relative (bf16 rounds P and O once each).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.foundationals.dinov2 as jdinov2
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.foundationals.dinov2 as dinov2
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.dinov2 import vit as jvit
from refiners_tpu.ops.attention import force_flash
from refiners_tpu.training_utils import metrics as jmetrics
from refiners_tpu_torch.conversion import load_jax_state_dict, nhwc_to_nchw
from refiners_tpu_torch.conversion.jax_bridge import _weight_layouts
from refiners_tpu_torch.foundationals.dinov2 import vit
from refiners_tpu_torch.ops import flash_attention as fa
from refiners_tpu_torch.training_utils import metrics

TOL = 1e-4
BF16_TOL = 1e-2
SMALL = dict(embedding_dim=128, num_layers=2, num_heads=2, patch_size=14)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bridge(jax_module: Any, port_module: torch.nn.Module) -> None:
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()}, strict=True)


def _randomize(jax_module: Any, seed: int) -> None:
    """Every JAX weight drawn from a seeded normal (LayerScales and norms
    included, so that none of them is the identity)."""
    rs = np.random.RandomState(seed)
    jax_module.load_state_dict(
        {k: (0.2 * rs.randn(*v.shape)).astype(np.float32) for k, v in jax_module.state_dict().items()}
    )


def _rel(got: Any, want: Any) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _images(batch: int, height: int, width: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(batch, 3, height, width).astype(np.float32)


def _run(jax_model: Any, port_model: torch.nn.Module, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    want = np.asarray(jax_model(jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    return got, want


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_modules_match_jax() -> None:
    rs = np.random.RandomState(0)
    tokens = rs.randn(2, 17, 32).astype(np.float32)

    jax_manual_seed(0)
    cases = [
        (jvit.ClassToken(32), vit.ClassToken(32)),
        (jvit.PositionalEmbedding(17, 32, patch_size=14), vit.PositionalEmbedding(17, 32, patch_size=14)),
        (jvit.Registers(4, 32), vit.Registers(4, 32)),
        (jvit.FeedForward(32, 64, jfl.GeLU()), vit.FeedForward(32, 64, fl.GeLU())),
        (jvit.FeedForward(32, 48, jfl.GLU(jfl.SiLU())), vit.FeedForward(32, 48, fl.GLU(fl.SiLU()))),
        (
            jvit.TransformerLayer(32, num_heads=2, norm_eps=1e-6, mlp_ratio=4, activation=jfl.GeLU()),
            vit.TransformerLayer(32, num_heads=2, norm_eps=1e-6, mlp_ratio=4, activation=fl.GeLU()),
        ),
    ]
    for jax_module, port_module in cases:
        _randomize(jax_module, 1)
        _bridge(jax_module, port_module)
        got, want = _run_tokens(jax_module, port_module, tokens)
        assert got.shape == want.shape, type(port_module).__name__
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=type(port_module).__name__)
    # the GLU doubles the first projection's width
    assert cases[4][1].layer("Linear_1", fl.Linear).weight.shape == (96, 32)

    jax_scale, scale = jvit.LayerScale(32, init_value=0.5), vit.LayerScale(32, init_value=0.5)
    np.testing.assert_array_equal(scale.weight.detach().numpy(), np.asarray(jax_scale.weight))
    np.testing.assert_allclose(scale(torch.from_numpy(tokens)).detach().numpy(), np.asarray(jax_scale(jnp.asarray(tokens))))


def _run_tokens(jax_module: Any, port_module: torch.nn.Module, tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    want = np.asarray(jax_module(jnp.asarray(tokens)))
    with torch.no_grad():
        got = port_module(torch.from_numpy(tokens)).numpy()
    return got, want


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("hw", [(518, 518), (224, 224), (224, 280), (280, 224)])
def test_interpolate_embedding_matches_jax(hw: tuple[int, int], antialias: bool) -> None:
    """A 37² position grid resized to the input's patch grid: rows follow the height."""
    rs = np.random.RandomState(2)
    table = rs.randn(2, 37 * 37 + 1, 16).astype(np.float32)
    image = np.zeros((1, 3, *hw), dtype=np.float32)
    jax_layer = jvit.InterpolateEmbedding(mode="bicubic", antialias=antialias, patch_size=14)
    layer = vit.InterpolateEmbedding(mode="bicubic", antialias=antialias, patch_size=14)
    want = np.asarray(jax_layer(jnp.asarray(table), jnp.asarray(image.transpose(0, 2, 3, 1))))
    got = layer(torch.from_numpy(table), torch.from_numpy(image)).numpy()
    assert got.shape == want.shape == (2, 1 + (hw[0] // 14) * (hw[1] // 14), 16)
    # float32 weights of each package's own making, on values up to ~4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the ViT at DINOv2's lengths
# ---------------------------------------------------------------------------


def _vit_pair(seed: int, **kwargs: Any) -> tuple[Any, dinov2.ViT]:
    jax_manual_seed(seed)
    jax_model = jdinov2.ViT(**SMALL, image_size=518, **kwargs)
    _randomize(jax_model, seed + 1)
    port_model = dinov2.ViT(**SMALL, image_size=518, **{k: _port_activation(v) for k, v in kwargs.items()})
    _bridge(jax_model, port_model)
    return jax_model, port_model


def _port_activation(value: Any) -> Any:
    if isinstance(value, jfl.GLU):
        return fl.GLU(fl.SiLU())
    return value


@pytest.mark.parametrize(
    "hw,registers,glu,tokens",
    [
        ((518, 518), 0, False, 1370),  # DINOv2's native size: K1's length on the card
        ((518, 518), 4, False, 1374),  # with registers
        ((224, 224), 0, False, 257),  # the Fréchet distance's size: plain on the card too
        ((224, 280), 4, False, 325),  # not square
        ((224, 224), 0, True, 257),  # the giant presets' SwiGLU feed-forward
    ],
)
def test_vit_matches_jax(hw: tuple[int, int], registers: int, glu: bool, tokens: int) -> None:
    kwargs: dict[str, Any] = dict(num_registers=registers, interpolate_antialias=registers > 0)
    if glu:
        kwargs.update(activation=jfl.GLU(jfl.SiLU()), feedforward_dim=96)
    jax_model, port_model = _vit_pair(3, **kwargs)
    got, want = _run(jax_model, port_model, _images(2, *hw, seed=4))
    assert got.shape == want.shape == (2, tokens, 128)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_vit_at_1374_tokens_matches_jax_flash_kernel() -> None:
    """The whole model with registers at 518²: the JAX package on its Pallas
    kernel (interpreter), the port on the plain version that K1 is held to."""
    jax_model, port_model = _vit_pair(5, num_registers=4, interpolate_antialias=True)
    x = _images(1, 518, 518, seed=6)
    with force_flash():
        want = np.asarray(jax_model(jnp.asarray(x.transpose(0, 2, 3, 1))))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1374, 128)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_at_the_k1_site_matches_jax(dtype: torch.dtype) -> None:
    """`fl.SelfAttention` at DINOv2's site (1374 tokens, d = 64, batch 2):
    the port's plain path against the JAX layer forced onto its flash kernel."""
    jax_manual_seed(7)
    jax_layer = jfl.SelfAttention(embedding_dim=128, num_heads=2)
    layer = fl.SelfAttention(embedding_dim=128, num_heads=2)
    _bridge(jax_layer, layer)
    x = np.random.RandomState(8).randn(2, 1374, 128).astype(np.float32)
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with force_flash():
        want = jax_layer.to(dtype=jax_dtype)(jnp.asarray(x, dtype=jax_dtype))
    before = fa.flash_attention_packed.launches
    with torch.no_grad():
        got = layer.to(dtype=dtype)(torch.from_numpy(x).to(dtype))
    assert fa.flash_attention_packed.launches == before  # CPU tensors: the plain path
    assert got.dtype == dtype and got.shape == (2, 1374, 128)
    got32, want32 = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert _rel(got32, want32) <= (1e-5 if dtype == torch.float32 else BF16_TOL)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DINOv2_small", "DINOv2_small_reg"])
def test_small_presets_match_jax(name: str) -> None:
    """Full width: the JAX preset's keys and shapes, and one forward at 518²."""
    jax_manual_seed(9)
    jax_model = getattr(jdinov2, name)()
    _randomize(jax_model, 10)
    port_model = getattr(dinov2, name)(device="cpu")
    assert isinstance(port_model, dinov2.ViT) and type(port_model).__name__ == name
    assert sorted(port_model.state_dict()) == sorted(jax_model.state_dict())
    _bridge(jax_model, port_model)
    got, want = _run(jax_model, port_model, _images(1, 518, 518, seed=11))
    assert got.shape == (1, 1374 if name.endswith("_reg") else 1370, 384)
    np.testing.assert_allclose(got, want, atol=TOL)


def _parameters(dim: int, layers: int, ffn: int, glu: bool, registers: int) -> int:
    """Parameters from the configuration: the class token, 37² + 1
    positions, the 14 × 14 patch convolution, the registers, per layer two
    LayerNorms, four attention projections, two LayerScales and the
    feed-forward (its first width doubled by a GLU), and the final norm."""
    first = 2 * ffn if glu else ffn
    per_layer = 2 * 2 * dim + 4 * (dim * dim + dim) + 2 * dim + (dim * first + first) + (ffn * dim + dim)
    return dim + (37 * 37 + 1) * dim + (3 * 14 * 14 * dim + dim) + registers * dim + layers * per_layer + 2 * dim


@pytest.mark.parametrize(
    "name,dim,layers,ffn,glu",
    [
        ("DINOv2_small", 384, 12, 1536, False),
        ("DINOv2_base", 768, 12, 3072, False),
        ("DINOv2_large", 1024, 24, 4096, False),
        ("DINOv2_giant", 1536, 40, 4096, True),
    ],
)
@pytest.mark.parametrize("reg", [False, True])
def test_presets_on_meta(name: str, dim: int, layers: int, ffn: int, glu: bool, reg: bool) -> None:
    """Every preset's keys and shapes (the port's layout) against the JAX
    preset's (`jax.eval_shape`, no memory), and its parameter count."""
    name += "_reg" if reg else ""
    want = jax.eval_shape(lambda: getattr(jdinov2, name)().state_dict())
    model = getattr(dinov2, name)(device="meta")
    layouts = _weight_layouts(model)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        shape = tuple(value.shape[i] for i in layouts[key]) if key in layouts else tuple(value.shape)
        assert tuple(got[key].shape) == shape, key
    n = sum(p.numel() for p in model.parameters())
    assert n == _parameters(dim, layers, ffn, glu, 4 if reg else 0) == sum(math.prod(v.shape) for v in want.values())
    assert model.num_registers == (4 if reg else 0)
    assert isinstance(model.layer(("Transformer", "TransformerLayer_1", "Residual_2", "FeedForward", "GLU" if glu else "GeLU"), fl.Module), fl.Activation)


def test_presets_default_to_the_card() -> None:
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only case")
    with pytest.raises((RuntimeError, AssertionError)):
        dinov2.DINOv2_small()


def test_preprocess_matches_jax() -> None:
    rs = np.random.RandomState(12)
    image = Image.fromarray(rs.randint(0, 256, (200, 300, 3), dtype=np.uint8))
    got = dinov2.preprocess(image)
    want = np.asarray(jdinov2.preprocess(image))
    assert got.shape == (3, 224, 224) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want[None])[0], atol=1e-6)
    assert dinov2.preprocess(image.convert("L"), dim=518).shape == (3, 518, 518)


# ---------------------------------------------------------------------------
# the Fréchet distance
# ---------------------------------------------------------------------------


def test_frechet_distance_matches_jax() -> None:
    rs = np.random.RandomState(13)
    a, b = rs.randn(64, 16), 0.5 + 1.5 * rs.randn(48, 16)
    got = metrics.frechet_distance(a, b)
    assert got == jmetrics.frechet_distance(a, b)
    assert got > 0
    assert abs(metrics.frechet_distance(a, a)) <= 1e-9 * np.trace(np.cov(a.T))
    # two gaussians: |Δμ|² + tr(Σa + Σb − 2 (Σa Σb)^½), here diagonal
    x = np.stack([rs.randn(4000), 2.0 * rs.randn(4000)], axis=1)
    y = np.stack([1.0 + 3.0 * rs.randn(4000), rs.randn(4000)], axis=1)
    sx, sy = np.cov(x.T), np.cov(y.T)
    exact = float(((x.mean(0) - y.mean(0)) ** 2).sum() + np.trace(sx) + np.trace(sy) - 2 * np.sqrt(np.diag(sx) * np.diag(sy)).sum())
    assert abs(metrics.frechet_distance(x, y) - exact) <= 0.05 * exact


def _write_pngs(directory: Path, count: int, seed: int) -> None:
    directory.mkdir()
    rs = np.random.RandomState(seed)
    for i in range(count):
        size = (rs.randint(180, 260), rs.randint(180, 260))
        Image.fromarray(rs.randint(0, 256, (*size, 3), dtype=np.uint8)).save(directory / f"{i:02d}.png")


def test_dinov2_frechet_distance_matches_jax(tmp_path: Path) -> None:
    """The representations (class tokens at 224²) and the distance between two
    directories of PNGs, batched unevenly."""
    _write_pngs(tmp_path / "a", 6, seed=14)
    _write_pngs(tmp_path / "b", 5, seed=15)
    jax_model, port_model = _vit_pair(16)

    dataset = metrics.DinoDataset(tmp_path / "a")
    assert len(dataset) == 6 and dataset[0].shape == (3, 224, 224)
    got = metrics.get_dinov2_representations(port_model, metrics._batched(dataset, 4))
    want = jmetrics.get_dinov2_representations(jax_model, jmetrics._batched(jmetrics.DinoDataset(tmp_path / "a"), 4))
    assert got.dtype == np.float64 and got.shape == (6, 128)
    np.testing.assert_allclose(got, want, atol=TOL)

    launches = fa.flash_attention_packed.launches
    distance = metrics.dinov2_frechet_distance(tmp_path / "a", tmp_path / "b", port_model, batch_size=4)
    want_distance = jmetrics.dinov2_frechet_distance(tmp_path / "a", tmp_path / "b", jax_model, batch_size=4)
    assert fa.flash_attention_packed.launches == launches
    assert np.isfinite(distance) and distance > 0
    assert abs(distance - want_distance) <= 1e-3 * abs(want_distance)
