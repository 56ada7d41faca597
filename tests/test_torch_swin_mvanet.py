"""The port's Swin Transformer, MVANet and BoxSegmenter against the JAX
package, on the CPU.

JAX modules are built from a seed (batch-norm statistics drawn too, so that
they matter) and bridged into the port with `load_jax_state_dict(strict=True)`;
inputs are seeded numpy arrays, NHWC to JAX and NCHW to the port. MVANet only
runs at 1024² (MCLM's fixed 16 × 16 grid) and batch 1, so the whole model is
`MVANet(depths=[1, 1, 1, 1])` at its full width, the JAX side under
`jax.jit`; one module-scoped build serves the model and the BoxSegmenter,
whose request runs each package's own preprocessing, model and
postprocessing once.

Tolerances, float32: 1e-4 absolute for Swin and its pieces (summation order
only), 1e-4 absolute on MVANet's logits (summation order through the
decoder's convolutions and its 16384 × 5376 attentions; the observed error
is ~1e-6); the BoxSegmenter's 8-bit masks may differ by one level where the
two packages' probabilities round to either side of a half level.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.foundationals.swin.swin_transformer as jswin
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.foundationals.swin.swin_transformer as swin
from refiners_tpu.fluxion import manual_seed as jax_manual_seed
from refiners_tpu.foundationals.swin import SwinTransformer as JaxSwinTransformer
from refiners_tpu.foundationals.swin.mvanet import MVANet as JaxMVANet
from refiners_tpu.foundationals.swin.mvanet import mclm as jmclm
from refiners_tpu.foundationals.swin.mvanet import mcrm as jmcrm
from refiners_tpu.foundationals.swin.mvanet import mvanet as jmvanet
from refiners_tpu.foundationals.swin.mvanet import utils as jutils
from refiners_tpu.solutions import BoxSegmenter as JaxBoxSegmenter
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.foundationals.swin import SwinTransformer
from refiners_tpu_torch.foundationals.swin.mvanet import MVANet, mclm, mcrm, mvanet, utils
from refiners_tpu_torch.solutions import BoxSegmenter

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _randomize_statistics(jax_module: Any, seed: int) -> None:
    """Batch-norm statistics and affines away from the identity."""
    rs = np.random.RandomState(seed)
    state = {k: np.asarray(v) for k, v in jax_module.state_dict().items()}
    for key, value in state.items():
        if key.endswith(("running_mean", "BatchNorm2d.bias")):
            state[key] = (0.1 * rs.randn(*value.shape)).astype(np.float32)
        elif key.endswith(("running_var", "BatchNorm2d.weight")):
            state[key] = (0.5 + rs.rand(*value.shape)).astype(np.float32)
    jax_module.load_state_dict({k: jnp.asarray(v) for k, v in state.items()})


def _pair(build_jax: Any, build_port: Any, seed: int) -> tuple[Any, Any]:
    jax_manual_seed(seed)
    jax_module = build_jax()
    _randomize_statistics(jax_module, seed + 1)
    port_module = build_port()
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()}, strict=True)
    return jax_module, port_module


def _jitted(fn: Any, *args: Any) -> Any:
    """`jax.jit(fn)(*args)`. The JAX package's `get_attn_mask` caches what it
    returns while traced (a tracer, which a later trace cannot use), so its
    cache is cleared after each traced call."""
    try:
        return jax.block_until_ready(jax.jit(fn)(*args))
    finally:
        jswin.get_attn_mask.cache_clear()


def _views(x: np.ndarray) -> np.ndarray:
    """(B, V, C, H, W) → (B, V, H, W, C)."""
    return np.ascontiguousarray(x.transpose(0, 1, 3, 4, 2))


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


def test_window_helpers_match_jax() -> None:
    rs = np.random.RandomState(0)
    grid = rs.randn(2, 14, 14, 3).astype(np.float32)
    windows = swin.to_windows(torch.from_numpy(grid), 7)
    np.testing.assert_array_equal(windows.numpy(), np.asarray(jswin.to_windows(jnp.asarray(grid), 7)))
    np.testing.assert_array_equal(swin.FromWindows()(windows).numpy(), grid)
    for size, window in ((14, 7), (24, 12), (132, 12)):
        np.testing.assert_array_equal(swin.get_attn_mask(size, window), np.asarray(jswin.get_attn_mask(size, window)))
    for window in (7, 12):
        np.testing.assert_array_equal(swin._relative_position_index(window), jswin._relative_position_index(window))
    # padding to a multiple of the window, at the bottom and right
    odd = rs.randn(1, 20, 20, 3).astype(np.float32)
    padded = swin.Pad(7)(torch.from_numpy(odd)).numpy()
    assert padded.shape == (1, 21, 21, 3)
    np.testing.assert_array_equal(padded, np.asarray(jswin.Pad(7)(jnp.asarray(odd))))
    np.testing.assert_array_equal(
        swin.Roll((1, -3), (2, -3))(torch.from_numpy(odd)).numpy(), np.asarray(jswin.Roll((1, -3), (2, -3))(jnp.asarray(odd)))
    )
    tokens = torch.zeros(2, 36, 5)
    assert swin.SquareUnflatten(1)(tokens).shape == (2, 6, 6, 5)
    assert swin.WindowUnflatten(3, 1)(torch.zeros(2, 6, 5)).shape == (2, 2, 3, 5)


def test_relative_position_bias_is_a_buffer_under_jax_key() -> None:
    jax_rpb, rpb = _pair(lambda: jswin.RelativePositionBias(7, 3), lambda: swin.RelativePositionBias(7, 3), seed=1)
    assert "relative_position_index" in dict(rpb.named_buffers())
    np.testing.assert_array_equal(rpb.relative_position_index.numpy(), swin._relative_position_index(7))
    np.testing.assert_allclose(rpb().detach().numpy(), np.asarray(jax_rpb()), atol=0)


@pytest.mark.parametrize("shift", [False, True])
def test_window_sdpa_matches_jax(shift: bool) -> None:
    jax_sdpa, sdpa = _pair(lambda: jswin.WindowSDPA(7, 3, shift=shift), lambda: swin.WindowSDPA(7, 3, shift=shift), seed=2)
    x = np.random.RandomState(3).randn(2, 9, 49, 3 * 24).astype(np.float32)
    with torch.no_grad():
        got = sdpa(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sdpa(jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("size,shift", [(21, 0), (20, 3), (13, 3)])
def test_swin_block_matches_jax(size: int, shift: int) -> None:
    """A block on a grid that is (13, 20) or is not (21) padded to the window;
    shifted blocks add the region mask."""
    jax_block, block = _pair(
        lambda: jswin.SwinTransformerBlock(24, num_heads=3, window_size=7, shift_size=shift),
        lambda: swin.SwinTransformerBlock(24, num_heads=3, window_size=7, shift_size=shift),
        seed=4,
    )
    x = np.random.RandomState(5).randn(2, size * size, 24).astype(np.float32)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_block(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("size", [14, 13])
def test_patch_merging_matches_jax(size: int) -> None:
    jax_merge, merge = _pair(lambda: jswin.PatchMerging(16), lambda: swin.PatchMerging(16), seed=6)
    x = np.random.RandomState(7).randn(2, size * size, 16).astype(np.float32)
    with torch.no_grad():
        got = merge(torch.from_numpy(x)).numpy()
    assert got.shape == (2, ((size + 1) // 2) ** 2, 32)
    np.testing.assert_allclose(got, np.asarray(jax_merge(jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("size", [448, 400])
def test_swin_transformer_matches_jax(size: int) -> None:
    """Reduced width (32), window 7 at 448² (every level a multiple of the
    window) and 400² (every level padded): the five-level pyramid, NCHW."""
    config = dict(embedding_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], window_size=7)
    jax_model, model = _pair(lambda: JaxSwinTransformer(**config), lambda: SwinTransformer(**config), seed=8)
    x = np.random.RandomState(9).randn(1, 3, size, size).astype(np.float32)
    want = _jitted(lambda m, x: m(x), jax_model, jnp.asarray(nchw_to_nhwc(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert isinstance(got, tuple) and len(got) == len(want) == 5
    side = size // 4
    sides = [-(-side // 8), -(-side // 4), -(-side // 2), side, side]
    for level, (g, w, s) in enumerate(zip(got, want, sides)):
        assert g.shape[-2:] == (s, s), level
        np.testing.assert_allclose(g.numpy(), nhwc_to_nchw(np.asarray(w)), atol=TOL, err_msg=f"level {level}")


# ---------------------------------------------------------------------------
# MVANet's pieces, at their shapes in the model (1024² input, width 128)
# ---------------------------------------------------------------------------


def test_multi_view_helpers_match_jax() -> None:
    rs = np.random.RandomState(10)
    x = rs.randn(1, 8, 32, 32).astype(np.float32)
    split = utils.PatchSplit()(torch.from_numpy(x))
    assert split.shape == (1, 4, 8, 16, 16)
    np.testing.assert_array_equal(_views(split.numpy()), np.asarray(jutils.PatchSplit()(jnp.asarray(nchw_to_nhwc(x)))))
    np.testing.assert_array_equal(utils.PatchMerge()(split).numpy(), x)
    pooled = utils.MultiPool([1, 2, 4])(torch.from_numpy(x))
    want = jutils.MultiPool([1, 2, 4])(jnp.asarray(nchw_to_nhwc(x)))
    assert pooled.shape == want.shape == (1, 32 * 32 + 16 * 16 + 8 * 8, 1, 8)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), atol=1e-6)
    split_view = jmvanet.SplitMultiView()(jnp.asarray(nchw_to_nhwc(x)))
    np.testing.assert_allclose(_views(mvanet.SplitMultiView()(torch.from_numpy(x)).numpy()), np.asarray(split_view), atol=1e-6)
    for layer, jax_layer in ((utils.Rescale(0.5, "bilinear"), jutils.Rescale(0.5, "bilinear")),
                             (utils.Rescale(2), jutils.Rescale(2)),
                             (utils.Interpolate((64, 64), "nearest"), jutils.Interpolate((64, 64), "nearest"))):  # fmt: skip
        np.testing.assert_allclose(
            nchw_to_nhwc(layer(torch.from_numpy(x)).numpy()), np.asarray(jax_layer(jnp.asarray(nchw_to_nhwc(x)))), atol=1e-6
        )
    pos = mclm.PositionEmbeddingSine(64)(16, 16)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jmclm.PositionEmbeddingSine(64)(16, 16)))


def test_batch_norm_prelu_and_attention_match_jax() -> None:
    rs = np.random.RandomState(11)
    jax_cbr, cbr = _pair(lambda: jmvanet.CBR(16, 24), lambda: mvanet.CBR(16, 24), seed=12)
    x = rs.randn(2, 16, 9, 11).astype(np.float32) * 3
    with torch.no_grad():
        got = cbr(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(nchw_to_nhwc(got), np.asarray(jax_cbr(jnp.asarray(nchw_to_nhwc(x)))), atol=TOL)
    bn = cbr.layer("BatchNorm2d", utils.BatchNorm2d)
    assert {name for name, _ in bn.named_buffers()} == {"running_mean", "running_var", "num_batches_tracked"}

    jax_mha, mha = _pair(lambda: jutils.MultiheadAttention(32, 4), lambda: utils.MultiheadAttention(32, 4), seed=13)
    assert sorted(mha.state_dict()) == ["in_proj_bias", "in_proj_weight", "out_proj.bias", "out_proj.weight"]
    q, k = rs.randn(50, 1, 32).astype(np.float32), rs.randn(70, 1, 32).astype(np.float32)
    v = rs.randn(70, 1, 32).astype(np.float32)
    with torch.no_grad():
        got = mha(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)))), atol=1e-5)
    # torch's own MultiheadAttention on the same weights (its layout, seq-first)
    ref = torch.nn.MultiheadAttention(32, 4)
    ref.load_state_dict(mha.state_dict())
    with torch.no_grad():
        want, _ = ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_mclm_matches_jax() -> None:
    """MCLM at the model's (1, 5, 128, 16, 16); its two LayerNorms keep one key each."""
    jax_mclm, module = _pair(lambda: jmclm.MCLM(128), lambda: mclm.MCLM(128), seed=14)
    assert sorted(module.state_dict()) == sorted(jax_mclm.state_dict())
    assert sum(1 for m in module.modules() if isinstance(m, fl.LayerNorm)) == 2
    x = np.random.RandomState(15).randn(1, 5, 128, 16, 16).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(_views(got), np.asarray(jax_mclm(jnp.asarray(_views(x)))), atol=TOL)


def test_mcrm_matches_jax() -> None:
    """MCRM at the model's 32² level (dec_blk4)."""
    jax_mcrm, module = _pair(lambda: jmcrm.MCRM(128, 32), lambda: mcrm.MCRM(128, 32), seed=16)
    x = np.random.RandomState(17).randn(1, 5, 128, 32, 32).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(_views(got), np.asarray(jax_mcrm(jnp.asarray(_views(x)))), atol=TOL)


def test_pyramid_matches_jax() -> None:
    """The decoder's neck on the five levels of a 1024² input's multi-view
    pyramid (channels 1024, 512, 256, 128, 128 at 16², 16², 32², 64², 128²)."""
    jax_pyramid, pyramid = _pair(lambda: jmvanet.Pyramid(), lambda: mvanet.Pyramid(), seed=18)
    rs = np.random.RandomState(19)
    shapes = [(1024, 16), (512, 32), (256, 64), (128, 128), (128, 128)]
    levels = [rs.randn(1, 5, c, s, s).astype(np.float32) for c, s in shapes]
    want = _jitted(lambda m, *xs: m(*xs), jax_pyramid, *(jnp.asarray(_views(x)) for x in levels))
    with torch.no_grad():
        got = pyramid(*(torch.from_numpy(x) for x in levels)).numpy()
    assert got.shape == (1, 5, 128, 128, 128)
    np.testing.assert_allclose(_views(got), np.asarray(want), atol=TOL)


def test_shallow_upscaler_matches_jax() -> None:
    """256² → 1024² on the shallow features (1, 128, 1024, 1024) of the
    ``mvanet`` context."""
    jax_up, up = _pair(lambda: jmvanet.ShallowUpscaler(), lambda: mvanet.ShallowUpscaler(), seed=20)
    rs = np.random.RandomState(21)
    x, shallow = rs.randn(1, 128, 256, 256).astype(np.float32), rs.randn(1, 128, 1024, 1024).astype(np.float32)
    jax_chain, chain = jfl.Chain(jax_up), fl.Chain(up)
    jax_chain.set_context("mvanet", {"shallow": jnp.asarray(nchw_to_nhwc(shallow))})
    chain.set_context("mvanet", {"shallow": torch.from_numpy(shallow)})
    with torch.no_grad():
        got = chain(torch.from_numpy(x)).numpy()
    want = nhwc_to_nchw(np.asarray(jax_chain(jnp.asarray(nchw_to_nhwc(x)))))
    assert got.shape == want.shape == (1, 128, 1024, 1024)
    assert float(np.abs(got - want).max()) <= TOL


# ---------------------------------------------------------------------------
# the whole model and the BoxSegmenter
# ---------------------------------------------------------------------------

IMAGE_SIZE = (300, 200)  # (width, height)
BOX = (30, 20, 250, 180)


@pytest.fixture(scope="module")
def segmented() -> dict[str, Any]:
    """One request through each package's BoxSegmenter, both on
    `MVANet(depths=[1, 1, 1, 1])` with the same weights; the model's input and
    logits are recorded on both sides."""
    jax_model, model = _pair(lambda: JaxMVANet(depths=[1, 1, 1, 1]), lambda: MVANet(depths=[1, 1, 1, 1]), seed=22)
    image = Image.fromarray(np.random.RandomState(23).randint(0, 256, (IMAGE_SIZE[1], IMAGE_SIZE[0], 3), dtype=np.uint8))
    record: dict[str, Any] = {}

    seg = BoxSegmenter.__new__(BoxSegmenter)
    seg.margin, seg.model = 0.05, model.eval()
    model.register_forward_hook(lambda _m, inputs, out: record.update(input=inputs[0].numpy(), logits=out.numpy()))
    predict = seg.predict
    seg.predict = lambda img: record.setdefault("prediction", predict(img))  # type: ignore[method-assign]
    record["mask"] = seg.run(image, BOX)

    jax_seg = JaxBoxSegmenter.__new__(JaxBoxSegmenter)
    jax_seg.margin, jax_seg.model = 0.05, jax_model
    def jax_predict(m: Any, x: jax.Array) -> jax.Array:
        logits = _jitted(lambda m, x: m(x), m, x)
        record.update(jax_input=nhwc_to_nchw(np.asarray(x)), jax_logits=nhwc_to_nchw(np.asarray(logits)))
        return jax.nn.sigmoid(logits)

    jax_seg._predict = jax_predict
    jax_predict_image = jax_seg.predict
    jax_seg.predict = lambda img: record.setdefault("jax_prediction", jax_predict_image(img))  # type: ignore[method-assign]
    record["jax_mask"] = jax_seg.run(image, BOX)
    record["box"] = seg.add_margin(BOX)
    return record


def test_mvanet_matches_jax(segmented: dict[str, Any]) -> None:
    """The whole model at 1024² (reduced depths, full width) on the same input."""
    np.testing.assert_allclose(segmented["input"], segmented["jax_input"], atol=1e-6)
    logits = segmented["logits"]
    assert logits.shape == (1, 1, 1024, 1024) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, segmented["jax_logits"], atol=TOL)


def test_mvanet_keys_at_full_depth_match_jax() -> None:
    want = jax.eval_shape(lambda: JaxMVANet().state_dict())
    model = MVANet(device="meta")
    assert sorted(model.state_dict()) == sorted(want)
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(v.shape)) for k, v in want.items() if "running" not in k and "num_batches" not in k and "relative_position_index" not in k)


def test_box_segmenter_predict_and_run_match_jax(segmented: dict[str, Any]) -> None:
    x0, y0, x1, y1 = segmented["box"]
    prediction, jax_prediction = segmented["prediction"], segmented["jax_prediction"]
    assert prediction.mode == jax_prediction.mode == "L" and prediction.size == (x1 - x0, y1 - y0)
    mask, jax_mask = segmented["mask"], segmented["jax_mask"]
    assert mask.mode == "L" and mask.size == IMAGE_SIZE
    for got, want in ((prediction, jax_prediction), (mask, jax_mask)):
        diff = np.abs(np.asarray(got, dtype=np.int16) - np.asarray(want, dtype=np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    arr = np.asarray(mask)
    outside = np.ones_like(arr, dtype=bool)
    outside[max(y0, 0) : y1, max(x0, 0) : x1] = False
    assert arr[outside].max() == 0  # nothing pasted outside the grown box


# the geometry cases of tests/test_solutions.py, on the port's BoxSegmenter


@pytest.fixture
def geometry() -> BoxSegmenter:
    seg = BoxSegmenter.__new__(BoxSegmenter)  # no MVANet: geometry only
    seg.margin = 0.05
    return seg


def test_add_margin(geometry: BoxSegmenter) -> None:
    assert geometry.add_margin((100, 100, 300, 200)) == (90, 95, 310, 205)
    geometry.margin = 0.0
    assert geometry.add_margin((10, 10, 20, 20)) == (10, 10, 20, 20)


def test_crop_pad_inside() -> None:
    img = Image.fromarray((np.arange(100 * 100 * 3) % 255).astype(np.uint8).reshape(100, 100, 3))
    out = BoxSegmenter.crop_pad(img, (10, 20, 60, 70))
    assert out.size == (50, 50)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(img)[20:70, 10:60])


def test_crop_pad_out_of_bounds_pads_black() -> None:
    img = Image.new("RGB", (40, 40), (200, 10, 10))
    out = BoxSegmenter.crop_pad(img, (-10, -10, 50, 50))
    assert out.size == (60, 60)
    arr = np.asarray(out)
    np.testing.assert_array_equal(arr[:10, :, :], 0)
    np.testing.assert_array_equal(arr[10:50, 10:50], np.asarray(img))


def test_run_pastes_prediction_at_box(geometry: BoxSegmenter, monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(geometry, "predict", lambda img: Image.new("L", img.size, 255))
    geometry.margin = 0.0
    mask = geometry.run(Image.new("RGB", (100, 80)), box_prompt=(20, 10, 60, 50))
    assert mask.size == (100, 80)
    arr = np.asarray(mask)
    np.testing.assert_array_equal(arr[10:50, 20:60], 255)
    assert arr.sum() == 255 * 40 * 40
    assert geometry.run(Image.new("RGB", (30, 20))).size == (30, 20)  # no box: the whole image


def test_box_segmenter_loads_a_safetensors_file(tmp_path: Any, monkeypatch: pytest.MonkeyPatch) -> None:
    """A file of the port's layout (written by `save_to_safetensors`) loads
    into the segmenter's model, strictly; a small stand-in model keeps the
    file small."""
    from refiners_tpu_torch.fluxion.utils import save_to_safetensors

    monkeypatch.setattr("refiners_tpu_torch.solutions.box_segmenter.MVANet", lambda device: fl.Linear(3, 2, device=device))
    weights = {"weight": torch.randn(2, 3), "bias": torch.randn(2)}
    save_to_safetensors(tmp_path / "mvanet.safetensors", weights)
    seg = BoxSegmenter(device="cpu", weights=tmp_path / "mvanet.safetensors")
    for key, value in weights.items():
        assert torch.equal(seg.model.state_dict()[key], value)
    save_to_safetensors(tmp_path / "partial.safetensors", {"weight": weights["weight"]})
    with pytest.raises(RuntimeError):
        BoxSegmenter(device="cpu", weights=tmp_path / "partial.safetensors")


def test_box_segmenter_defaults_to_the_card_and_loads_weights(tmp_path: Any) -> None:
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            BoxSegmenter()
    seg = BoxSegmenter(device="meta")
    assert seg.model.device.type == "meta" and not seg.model.training
    state = {k: torch.zeros(v.shape, dtype=v.dtype, device="meta") for k, v in seg.model.state_dict().items()}
    BoxSegmenter(device="meta", weights=state)
    with pytest.raises(RuntimeError):  # strict: a missing key
        BoxSegmenter(device="meta", weights=dict(list(state.items())[1:]))
