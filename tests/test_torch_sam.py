"""The port's Segment Anything slice against the JAX package, on the CPU.

JAX modules are built from a seed (their zero-initialized relative-position
embeddings made non-zero, so that the bias matters) and bridged into the
port with `load_jax_state_dict(strict=True)`. Inputs are numpy arrays handed
to both; NHWC (JAX) and NCHW (port) spatial tensors are converted at the
comparison. The facade runs at the JAX tests' reduced size
(`SAMViT(embedding_dim=64, num_layers=2, num_heads=4,
global_attention_indices=(1,))`, tests/foundationals/test_sam.py), where the
JAX package takes its plain attention: on the CPU both packages run the
same plain computation.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.foundationals.segment_anything as jsam
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.foundationals.segment_anything as sam
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.fluxion.utils import normalize as jax_normalize
from refiners_tpu.fluxion.utils import pad as jax_pad
from refiners_tpu.foundationals.segment_anything import image_encoder as jax_image_encoder
from refiners_tpu.foundationals.segment_anything import prompt_encoder as jax_prompt_encoder
from refiners_tpu.foundationals.segment_anything import utils as jax_utils
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.fluxion.utils import normalize, pad
from refiners_tpu_torch.foundationals.segment_anything import image_encoder, prompt_encoder, utils

REPO = Path(__file__).resolve().parents[1]
# float32 on both sides, one module: summation order only
MODULE_TOL = 1e-5
# the whole facade (ViT, prompt encoders, decoder, mask upsampling)
FACADE_TOL = 1e-4
# masks are compared where the logit is clear of the threshold
LOGIT_MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: Any, want: Any) -> float:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _randomize_relpos(jax_module: Any, seed: int) -> None:
    """Non-zero relative-position embeddings in every JAX attention layer."""
    rs = np.random.RandomState(seed)
    for attn in jax_module.layers(jax_image_encoder.RelativePositionAttention, recurse=True):
        for name in ("horizontal_embedding", "vertical_embedding"):
            shape = getattr(attn, name).shape
            setattr(attn, name, jnp.asarray((0.5 * rs.randn(*shape)).astype(np.float32)))


def _bridge(jax_module: Any, port_module: torch.nn.Module) -> None:
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()}, strict=True)


def _pair(build_jax: Callable[[], Any], build_port: Callable[[], torch.nn.Module], seed: int = 0) -> tuple[Any, Any]:
    jax_manual_seed(seed)
    jax_module = build_jax()
    if isinstance(jax_module, jfl.Chain):
        _randomize_relpos(jax_module, seed + 1)
    port_module = build_port()
    _bridge(jax_module, port_module)
    return jax_module, port_module


def _small_sam(package: Any, **kwargs: Any) -> Any:
    return package.SegmentAnything(
        image_encoder=package.SAMViT(embedding_dim=64, num_layers=2, num_heads=4, global_attention_indices=(1,)),
        point_encoder=package.PointEncoder(),
        mask_encoder=package.MaskEncoder(),
        mask_decoder=package.MaskDecoder(multimask_output=False),
        **kwargs,
    )


def _image(width: int, height: int, seed: int) -> Image.Image:
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (height, width, 3), dtype=np.uint8))


# ---------------------------------------------------------------------------
# fluxion pieces and utilities
# ---------------------------------------------------------------------------


def test_fluxion_pieces_match_jax() -> None:
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 5, 7).astype(np.float32)  # NCHW
    jax_ln, ln = _pair(lambda: jfl.LayerNorm2d(channels=6), lambda: fl.LayerNorm2d(channels=6))
    ln.weight.data.normal_()
    ln.bias.data.normal_()
    jax_ln.weight, jax_ln.bias = jnp.asarray(ln.weight.detach().numpy()), jnp.asarray(ln.bias.detach().numpy())
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jax_ln(jnp.asarray(nchw_to_nhwc(x)))), atol=MODULE_TOL)

    jax_mlp, mlp = _pair(lambda: jfl.MultiLinear(7, 3, 16, num_layers=3), lambda: fl.MultiLinear(7, 3, 16, num_layers=3))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mlp(jnp.asarray(x))), atol=MODULE_TOL)

    # torch.nn.functional.pad semantics on both sides, and NCHW/NHWC normalize
    widths = (1, 2, 0, 3, 2, 0)
    np.testing.assert_array_equal(pad(torch.from_numpy(x), widths).numpy(), np.asarray(jax_pad(jnp.asarray(x), widths)))
    img = rs.rand(1, 3, 8, 9).astype(np.float32)
    mean, std = [0.1, 0.2, 0.3], [0.5, 0.6, 0.7]
    np.testing.assert_allclose(
        nchw_to_nhwc(normalize(torch.from_numpy(img), mean, std).numpy()),
        np.asarray(jax_normalize(jnp.asarray(nchw_to_nhwc(img)), mean, std)),
        atol=1e-6,
    )
    for layer, value in ((fl.Sin(), np.sin(x)), (fl.Cos(), np.cos(x)), (fl.Multiply(2, -1), 2 * x - 1)):
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), value, atol=1e-6)
    assert fl.Squeeze(1)(torch.zeros(2, 1, 3)).shape == (2, 3)
    assert fl.Parameter(4, 5)(torch.zeros(3)).shape == (3, 4, 5)


@pytest.mark.parametrize("size", [(400, 600), (600, 400), (333, 512), (1024, 1024)])
def test_postprocess_masks_matches_jax(size: tuple[int, int]) -> None:
    """Bilinear up to 1024², crop, then down to the original size: the
    downsampling half-pixel convention of `F.interpolate` against
    `jax.image.resize(antialias=False)`."""
    low = np.random.RandomState(1).randn(1, 2, 256, 256).astype(np.float32)
    want = jax_utils.postprocess_masks(jnp.asarray(low), size, 1024)
    got = utils.postprocess_masks(torch.from_numpy(low), size, 1024)
    assert got.shape == (1, 2, *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_preprocessing_matches_jax() -> None:
    image = _image(600, 400, seed=2)
    want = jax_utils.preprocess_image(image, 1024)
    got = utils.preprocess_image(image, 1024)
    np.testing.assert_allclose(nchw_to_nhwc(got.numpy()), np.asarray(want), atol=1e-5)
    assert utils.compute_scaled_size((400, 600), 1024) == jax_utils.compute_scaled_size((400, 600), 1024)
    coords = np.asarray([[[10.0, 20.0], [599.0, 399.0]]], dtype=np.float32)
    np.testing.assert_allclose(
        utils.normalize_coordinates(torch.from_numpy(coords), (400, 600), 1024).numpy(),
        np.asarray(jax_utils.normalize_coordinates(jnp.asarray(coords), (400, 600), 1024)),
        atol=1e-7,
    )


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window_size", [14, None])
def test_transformer_layer_matches_jax(window_size: int | None) -> None:
    """A windowed layer (16 × 16 padded to two 14-windows a side) and a global one."""
    kwargs = dict(embedding_dim=64, num_heads=4, feedforward_dim=256, image_embedding_size=(16, 16), window_size=window_size)
    jax_layer, layer = _pair(
        lambda: jax_image_encoder.TransformerLayer(**kwargs), lambda: image_encoder.TransformerLayer(**kwargs), seed=3
    )
    x = np.random.RandomState(4).randn(1, 16, 16, 64).astype(np.float32)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_layer(jnp.asarray(x))), atol=MODULE_TOL)


def test_neck_matches_jax() -> None:
    jax_neck, neck = _pair(lambda: jax_image_encoder.Neck(in_channels=64), lambda: image_encoder.Neck(in_channels=64))
    x = np.random.RandomState(5).randn(1, 16, 16, 64).astype(np.float32)  # channels-last, as the ViT gives it
    with torch.no_grad():
        got = neck(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 256, 16, 16)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jax_neck(jnp.asarray(x))), atol=MODULE_TOL)


@pytest.mark.parametrize("with_box", [False, True])
def test_point_encoder_matches_jax(with_box: bool) -> None:
    jax_encoder, encoder = _pair(jax_prompt_encoder.PointEncoder, prompt_encoder.PointEncoder, seed=6)
    points = dict(foreground_points=[(0.2, 0.3), (0.7, 0.1)], background_points=[(0.5, 0.5)])
    if with_box:
        points["box_points"] = [[(0.1, 0.1), (0.9, 0.8)]]
    jax_coords, jax_mask = jax_encoder.points_to_tensor(**points)
    coords, type_mask = encoder.points_to_tensor(**points)
    np.testing.assert_array_equal(type_mask.numpy(), np.asarray(jax_mask))
    jax_encoder.set_type_mask(np.asarray(jax_mask))
    encoder.set_type_mask(type_mask)
    want = jax_encoder(jax_coords)
    with torch.no_grad():
        got = encoder(coords).numpy()
    # three points and a box's two corners; without a box, one NOT_A_POINT pad
    assert got.shape == (1, 5 if with_box else 4, 256)
    np.testing.assert_allclose(got, np.asarray(want), atol=MODULE_TOL)
    with torch.no_grad():
        dense = encoder.get_dense_positional_embedding((16, 16)).numpy()
    np.testing.assert_allclose(
        nchw_to_nhwc(dense), np.asarray(jax_encoder.get_dense_positional_embedding((16, 16))), atol=MODULE_TOL
    )


def test_mask_encoder_matches_jax() -> None:
    """The dense branch of a `low_res_mask` prompt (ROADMAP Queue 3 watch list)."""
    jax_encoder, encoder = _pair(jax_prompt_encoder.MaskEncoder, prompt_encoder.MaskEncoder, seed=7)
    mask = np.random.RandomState(8).randn(1, 1, 256, 256).astype(np.float32)
    with torch.no_grad():
        got = encoder(torch.from_numpy(mask)).numpy()
        no_mask = encoder.get_no_mask_dense_embedding((64, 64)).numpy()
    assert got.shape == (1, 256, 64, 64)
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jax_encoder(jnp.asarray(nchw_to_nhwc(mask)))), atol=MODULE_TOL)
    np.testing.assert_array_equal(nchw_to_nhwc(no_mask), np.asarray(jax_encoder.get_no_mask_dense_embedding((64, 64))))


@pytest.mark.parametrize("multimask_output", [True, False])
def test_mask_decoder_matches_jax(multimask_output: bool) -> None:
    jax_decoder, decoder = _pair(
        lambda: jsam.MaskDecoder(multimask_output=multimask_output),
        lambda: sam.MaskDecoder(multimask_output=multimask_output),
        seed=9,
    )
    rs = np.random.RandomState(10)
    image, mask, positional = (rs.randn(1, 64, 64, 256).astype(np.float32) for _ in range(3))  # NHWC
    points = rs.randn(1, 3, 256).astype(np.float32)
    jax_decoder.set_image_embedding(jnp.asarray(image))
    jax_decoder.set_mask_embedding(jnp.asarray(mask))
    jax_decoder.set_point_embedding(jnp.asarray(points))
    jax_decoder.set_dense_positional_embedding(jnp.asarray(positional))
    want_masks, want_iou = jax_decoder()
    decoder.set_image_embedding(torch.from_numpy(nhwc_to_nchw(image)))
    decoder.set_mask_embedding(torch.from_numpy(nhwc_to_nchw(mask)))
    decoder.set_point_embedding(torch.from_numpy(points))
    decoder.set_dense_positional_embedding(torch.from_numpy(nhwc_to_nchw(positional)))
    with torch.no_grad():
        masks, iou = decoder()
    assert masks.shape == (1, 3 if multimask_output else 1, 256, 256)
    assert _rel(masks.numpy(), want_masks) <= MODULE_TOL
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=MODULE_TOL)


def test_batched_prompt_decode_matches_jax() -> None:
    """Two prompt sets decoded in one pass (ROADMAP Queue 3 watch list): equal
    to the JAX decoder on the same batch and to one decode per set."""
    jax_decoder, decoder = _pair(
        lambda: jsam.MaskDecoder(multimask_output=False), lambda: sam.MaskDecoder(multimask_output=False), seed=19
    )
    rs = np.random.RandomState(20)
    image, mask = (rs.randn(2, 64, 64, 256).astype(np.float32) for _ in range(2))  # NHWC
    positional = rs.randn(1, 64, 64, 256).astype(np.float32)
    points = rs.randn(2, 3, 256).astype(np.float32)
    jax_decoder.set_image_embedding(jnp.asarray(image))
    jax_decoder.set_mask_embedding(jnp.asarray(mask))
    jax_decoder.set_point_embedding(jnp.asarray(points))
    jax_decoder.set_dense_positional_embedding(jnp.asarray(positional))
    want_masks, want_iou = jax_decoder()

    def decode(batch: slice) -> tuple[torch.Tensor, torch.Tensor]:
        decoder.set_image_embedding(torch.from_numpy(nhwc_to_nchw(image[batch])))
        decoder.set_mask_embedding(torch.from_numpy(nhwc_to_nchw(mask[batch])))
        decoder.set_point_embedding(torch.from_numpy(points[batch]))
        decoder.set_dense_positional_embedding(torch.from_numpy(nhwc_to_nchw(positional)))
        with torch.no_grad():
            return decoder()

    masks, iou = decode(slice(0, 2))
    assert masks.shape == (2, 1, 256, 256)
    assert _rel(masks.numpy(), want_masks) <= MODULE_TOL
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=MODULE_TOL)
    for b in range(2):
        one_masks, one_iou = decode(slice(b, b + 1))
        assert _rel(one_masks.numpy(), masks[b : b + 1].numpy()) <= MODULE_TOL
        np.testing.assert_allclose(one_iou.numpy(), iou[b : b + 1].numpy(), atol=MODULE_TOL)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models() -> tuple[Any, Any]:
    jax_model, model = _pair(lambda: _small_sam(jsam), lambda: _small_sam(sam, device="cpu"), seed=11)
    return jax_model, model


@pytest.fixture(scope="module")
def embeddings(models: tuple[Any, Any]) -> tuple[Any, Any]:
    """A non-square image (600 × 400) encoded by both."""
    jax_model, model = models
    image = _image(600, 400, seed=12)
    with torch.no_grad():
        return jax_model.compute_image_embedding(image), model.compute_image_embedding(image)


PROMPTS: dict[str, dict[str, Any]] = {
    "points": dict(foreground_points=[(150.0, 120.0), (420.0, 260.0)], background_points=[(40.0, 350.0)]),
    "box": dict(box_points=[[(80.0, 60.0), (500.0, 330.0)]]),
}


def test_image_embedding_matches_jax(embeddings: tuple[Any, Any]) -> None:
    jax_embedding, embedding = embeddings
    assert embedding.features.shape == (1, 256, 64, 64)
    assert embedding.original_image_size == jax_embedding.original_image_size == (400, 600)
    assert _rel(nchw_to_nhwc(embedding.features.numpy()), jax_embedding.features) <= FACADE_TOL


def _predict_both(models: tuple[Any, Any], embeddings: tuple[Any, Any], **prompt: Any) -> tuple[list, list]:
    """(logits, iou, low-res logits, binarized masks) from each package."""
    (jax_model, model), (jax_embedding, embedding) = models, embeddings
    jax_low_res = prompt.pop("jax_low_res_mask", None)
    low_res = prompt.pop("low_res_mask", None)
    jax_logits, jax_iou, jax_low = jax_model.predict(jax_embedding, binarize=False, low_res_mask=jax_low_res, **prompt)
    jax_masks = jax_model.predict(jax_embedding, binarize=True, low_res_mask=jax_low_res, **prompt)[0]
    with torch.no_grad():
        logits, iou, low = model.predict(embedding, binarize=False, low_res_mask=low_res, **prompt)
        masks = model.predict(embedding, binarize=True, low_res_mask=low_res, **prompt)[0]
    return [np.asarray(a) for a in (jax_logits, jax_iou, jax_low, jax_masks)], [
        t.numpy() for t in (logits, iou, low, masks)
    ]


def _assert_predictions_match(want: list, got: list, size: tuple[int, int]) -> None:
    jax_logits, jax_iou, jax_low, jax_masks = want
    logits, iou, low, masks = got
    assert masks.shape == (1, 1, *size) and masks.dtype == np.bool_
    assert _rel(low, jax_low) <= FACADE_TOL
    assert _rel(logits, jax_logits) <= FACADE_TOL
    np.testing.assert_allclose(iou, jax_iou, atol=FACADE_TOL)
    clear = np.abs(jax_logits) > LOGIT_MARGIN
    np.testing.assert_array_equal(masks[clear], jax_masks[clear])
    assert 0 < masks.sum() < masks.size  # the comparison is not vacuous


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_predict_matches_jax(models: tuple[Any, Any], embeddings: tuple[Any, Any], prompt: str) -> None:
    want, got = _predict_both(models, embeddings, **PROMPTS[prompt])
    _assert_predictions_match(want, got, (400, 600))


def test_predict_with_a_low_res_mask_matches_jax(models: tuple[Any, Any], embeddings: tuple[Any, Any]) -> None:
    """A mask prompt: the MaskEncoder's dense branch inside `predict`
    (ROADMAP Queue 3 watch list), fed the previous prediction's logits."""
    low = np.random.RandomState(13).randn(1, 1, 256, 256).astype(np.float32)
    want, got = _predict_both(
        models, embeddings, **PROMPTS["points"], low_res_mask=torch.from_numpy(low), jax_low_res_mask=jnp.asarray(low)
    )
    _assert_predictions_match(want, got, (400, 600))


def test_predict_from_an_image_matches_jax(models: tuple[Any, Any]) -> None:
    """`predict` on a raw image encodes it first; a second, taller image."""
    jax_model, model = models
    image = _image(320, 480, seed=14)
    jax_logits, jax_iou, jax_low = jax_model.predict(image, binarize=False, **PROMPTS["box"])
    with torch.no_grad():
        logits, iou, low = model.predict(image, binarize=False, **PROMPTS["box"])
    assert logits.shape == (1, 1, 480, 320)
    assert _rel(low.numpy(), jax_low) <= FACADE_TOL
    np.testing.assert_allclose(iou.numpy(), np.asarray(jax_iou), atol=FACADE_TOL)


def test_predict_pipelined_equals_predict(models: tuple[Any, Any], embeddings: tuple[Any, Any]) -> None:
    _, model = models
    _, embedding = embeddings
    image = _image(256, 320, seed=15)
    inputs = [embedding, image, embedding]
    prompts = [PROMPTS["points"], PROMPTS["box"], dict(foreground_points=[(10.0, 20.0)])]
    with torch.no_grad():
        pipelined = model.predict_pipelined(inputs, prompts, binarize=False)
        for x, prompt, outputs in zip(inputs, prompts, pipelined, strict=True):
            for got, want in zip(outputs, model.predict(x, binarize=False, **prompt), strict=True):
                assert isinstance(got, np.ndarray)
                np.testing.assert_array_equal(got, want.numpy())


def test_hq_sam_matches_jax() -> None:
    """HQ-SAM injected into both, the JAX adapter's state dict loaded into the
    port's whole injected tree with strict key matching."""
    jax_manual_seed(16)
    jax_model = _small_sam(jsam)
    _randomize_relpos(jax_model, 17)
    jax_hq = jsam.HQSAMAdapter(jax_model).inject()
    model = _small_sam(sam, device="cpu")
    hq = sam.HQSAMAdapter(model).inject()
    _bridge(jax_hq, hq)
    assert set(hq.state_dict()) == set(jax_hq.state_dict())

    image = _image(600, 400, seed=18)
    jax_embedding = jax_model.compute_image_embedding(image)
    with torch.no_grad():
        embedding = model.compute_image_embedding(image)
    early = embedding.captured_contexts["hq_sam"]["early_vit_embedding"]
    assert early.shape == (1, 64, 64, 64)
    want = [np.asarray(a) for a in jax_model.predict(jax_embedding, binarize=False, **PROMPTS["points"])]
    with torch.no_grad():
        got = [t.numpy() for t in model.predict(embedding, binarize=False, **PROMPTS["points"])]
        masks = model.predict(embedding, **PROMPTS["points"])[0].numpy()
    assert _rel(got[2], want[2]) <= FACADE_TOL and _rel(got[0], want[0]) <= FACADE_TOL
    np.testing.assert_allclose(got[1], want[1], atol=FACADE_TOL)
    clear = np.abs(want[0]) > LOGIT_MARGIN
    np.testing.assert_array_equal(masks[clear], want[0][clear] > 0)

    # eject restores the base model
    hq.eject()
    jax_hq.eject()
    with torch.no_grad():
        base = model.predict(embedding, binarize=False, **PROMPTS["points"])[2].numpy()
    jax_base = np.asarray(jax_model.predict(jax_embedding, binarize=False, **PROMPTS["points"])[2])
    assert _rel(base, jax_base) <= FACADE_TOL


def test_segment_anything_h_keys_match_jax() -> None:
    """The full-width model's key paths and shapes, on the meta device (no
    memory, no initialization on the port's side)."""
    jax_manual_seed(0)
    jax_shapes = {k: tuple(v.shape) for k, v in jsam.SegmentAnythingH().state_dict().items()}
    port = sam.SegmentAnythingH(device="meta")
    assert set(port.state_dict()) == set(jax_shapes)
    linears = {f"{n}.weight" for n, m in port.named_modules(remove_duplicate=False) if isinstance(m, fl.Linear)}
    for key, value in port.state_dict().items():
        shape = jax_shapes[key]
        if key in linears:
            shape = shape[::-1]
        elif len(shape) == 4:
            perm = (2, 3, 0, 1) if "ConvTranspose2d" in key else (3, 2, 0, 1)
            shape = tuple(shape[i] for i in perm)
        assert tuple(value.shape) == shape, key
    assert len(list(port.layers(image_encoder.RelativePositionAttention, recurse=True))) == 32


_CPU_SAM = """
import json, sys
import numpy as np
from PIL import Image
from refiners_tpu_torch.foundationals.segment_anything import (
    HQSAMAdapter, MaskDecoder, MaskEncoder, PointEncoder, SAMViT, SegmentAnything,
)
from refiners_tpu_torch.ops import build

model = SegmentAnything(
    SAMViT(embedding_dim=32, num_layers=2, num_heads=2, global_attention_indices=(1,)),
    PointEncoder(), MaskEncoder(), MaskDecoder(multimask_output=False), device="cpu",
)
HQSAMAdapter(model).inject()
image = Image.fromarray(np.zeros((100, 150, 3), dtype=np.uint8))
masks, iou, low = model.predict(image, foreground_points=[(50.0, 40.0)])
print(json.dumps({
    "shape": list(masks.shape),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "triton": sorted(m for m in sys.modules if m == "triton" or m.startswith("triton.")),
    "refiners_tpu": sorted(m for m in sys.modules if m == "refiners_tpu" or m.startswith("refiners_tpu.")),
    "libraries_loaded": build.load_library.cache_info().currsize,
}))
"""


def test_sam_runs_on_cpu_without_jax_triton_or_a_cuda_build() -> None:
    """The SAM slice with HQ-SAM in a fresh interpreter: no JAX, no Triton,
    no JAX package, no CUDA library built or loaded."""
    proc = subprocess.run([sys.executable, "-c", _CPU_SAM], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"shape": [1, 1, 100, 150], "jax": [], "triton": [], "refiners_tpu": [], "libraries_loaded": 0}
