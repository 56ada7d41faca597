"""The rest of the port's fluxion layers and `fluxion.utils` against the JAX package, on the CPU.

Inputs are seeded numpy arrays handed to both; spatial tensors are NHWC on
the JAX side and NCHW in the port. Float32 on both sides: 1e-4 relative,
except where a layer only moves or selects values (padding, pooling,
pixel (un)shuffle, GetArg, Buffer), which must agree exactly.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu.fluxion.utils as jutils
import refiners_tpu_torch.fluxion.layers as fl
import refiners_tpu_torch.fluxion.utils as utils
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw

TOL = 1e-4


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ncl(x: np.ndarray) -> np.ndarray:
    """(B, L, C), the JAX package's 1-d layout, ↔ (B, C, L), the port's."""
    return np.ascontiguousarray(x.transpose(0, 2, 1))


def test_layer_names_match_jax() -> None:
    assert sorted(fl.__all__) == sorted(jfl.__all__)


# name: (builder given the fl namespace, input shape on the JAX side, layout, exact)
LAYER_CASES: dict[str, tuple[Callable[[Any], Any], tuple[int, ...], str, bool]] = {
    "sigmoid": (lambda ns: ns.Sigmoid(), (2, 5, 7), "flat", False),
    "instance_norm": (lambda ns: ns.InstanceNorm2d(6), (2, 7, 5, 6), "spatial", False),
    "instance_norm_eps": (lambda ns: ns.InstanceNorm2d(3, eps=1e-3), (1, 4, 4, 3), "spatial", False),
    "reflection_pad": (lambda ns: ns.ReflectionPad2d(2), (2, 6, 5, 3), "spatial", True),
    "maxpool1d": (lambda ns: ns.MaxPool1d(3, stride=2, padding=1), (2, 11, 4), "1d", True),
    "maxpool1d_default_stride": (lambda ns: ns.MaxPool1d(2), (1, 8, 3), "1d", True),
    "maxpool2d": (lambda ns: ns.MaxPool2d(2), (2, 8, 6, 3), "spatial", True),
    "maxpool2d_padded": (lambda ns: ns.MaxPool2d(3, stride=2, padding=1), (1, 9, 7, 4), "spatial", True),
    "maxpool2d_rect": (lambda ns: ns.MaxPool2d((2, 3), stride=(1, 2)), (1, 6, 9, 2), "spatial", True),
    "pixel_unshuffle_2": (lambda ns: ns.PixelUnshuffle(2), (2, 8, 6, 3), "spatial", True),
    "pixel_unshuffle_4": (lambda ns: ns.PixelUnshuffle(4), (1, 16, 8, 3), "spatial", True),
    "pixel_shuffle_2": (lambda ns: ns.PixelShuffle(2), (2, 3, 4, 12), "spatial", True),
    "pixel_shuffle_4": (lambda ns: ns.PixelShuffle(4), (1, 2, 3, 32), "spatial", True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_matches_jax(case: str) -> None:
    build, shape, layout, exact = LAYER_CASES[case]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    to_port, from_port = {"flat": (np.asarray, np.asarray), "spatial": (nhwc_to_nchw, nchw_to_nhwc),
                          "1d": (_ncl, _ncl)}[layout]  # fmt: skip
    want = np.asarray(build(jfl)(jnp.asarray(x)))
    with torch.no_grad():
        got = from_port(build(fl)(torch.tensor(to_port(x))).numpy())
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_unshuffle_channel_order(r: int) -> None:
    """Out channel c·r² + dy·r + dx holds pixel (y·r + dy, x·r + dx) of
    channel c, in both packages (T2I-Adapter's first layer relies on it),
    and PixelShuffle inverts it."""
    c, h, w = 3, 2 * r, 3 * r
    x = np.arange(c * h * w, dtype=np.float32).reshape(1, c, h, w)
    with torch.no_grad():
        y = fl.PixelUnshuffle(r)(torch.tensor(x)).numpy()
        back = fl.PixelShuffle(r)(torch.tensor(y)).numpy()
    for ch, dy, dx in ((0, 0, 0), (1, r - 1, 0), (2, 1, r - 1), (c - 1, r - 1, r - 1)):
        assert y[0, ch * r * r + dy * r + dx, 1, 2] == x[0, ch, r + dy, 2 * r + dx]
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(np.asarray(jfl.PixelUnshuffle(r)(jnp.asarray(nchw_to_nhwc(x)))), nchw_to_nhwc(y))


def test_get_arg_matches_jax() -> None:
    rs = np.random.RandomState(2)
    a, b, c = (rs.randn(2, 3).astype(np.float32) for _ in range(3))
    want = jfl.GetArg(1)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = fl.GetArg(1)(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(fl.GetArg(0).state_dict()) == []


def test_buffer_bridges_and_is_not_trained() -> None:
    jax_buffer, port_buffer = jfl.Buffer(2, 3), fl.Buffer(2, 3)
    assert list(port_buffer.state_dict()) == list(jax_buffer.state_dict()) == ["weight"]
    assert list(port_buffer.parameters()) == []
    np.testing.assert_array_equal(port_buffer(torch.zeros(5)).numpy(), np.zeros((2, 3), np.float32))
    values = np.random.RandomState(3).randn(2, 3).astype(np.float32)
    jax_buffer.load_state_dict({"weight": jnp.asarray(values)})
    chain = fl.Chain(fl.Linear(3, 3), port_buffer)
    load_jax_state_dict(chain.Buffer, {k: np.asarray(v) for k, v in jax_buffer.state_dict().items()})
    np.testing.assert_array_equal(chain(torch.zeros(1, 3)).detach().numpy(), np.asarray(jax_buffer(jnp.zeros(1))))
    assert port_buffer.dtype == torch.float32 and fl.Buffer(4, dtype=torch.bfloat16).weight.dtype == torch.bfloat16


def test_return_leaves_every_enclosing_chain_with_its_value() -> None:
    """`Return` raises ReturnException through nested chains unwrapped (no
    ChainError), carrying its input, in both packages; a layer after it does not run."""
    x = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    values = []
    for ns, exc, wrap in ((jfl, jfl.ReturnException, jnp.asarray), (fl, fl.ReturnException, torch.tensor)):
        ran = []
        chain = ns.Chain(ns.Chain(ns.Multiply(2.0), ns.Return()), ns.Lambda(lambda y: ran.append(y)))
        with pytest.raises(exc) as info:
            chain(wrap(x))
        assert not isinstance(info.value, fl.ChainError) and ran == []
        values.append(np.asarray(info.value.value))
    np.testing.assert_array_equal(values[1], values[0])
    np.testing.assert_array_equal(values[1], 2 * x)
    with pytest.raises(fl.ReturnException) as info:
        fl.Return()(torch.ones(1), torch.zeros(1))
    assert isinstance(info.value.value, tuple) and len(info.value.value) == 2


def test_breakpoint_calls_the_debugger_and_passes_its_input(monkeypatch: pytest.MonkeyPatch) -> None:
    calls: list[int] = []
    monkeypatch.setattr(builtins, "breakpoint", lambda: calls.append(1))
    x = torch.randn(2, 3)
    chain = fl.Chain(fl.Breakpoint(), fl.Multiply(3.0))
    assert torch.equal(chain(x), 3 * x)
    assert calls == [1] and chain.Breakpoint.parent is chain
    a, b = fl.Breakpoint()(x, 2 * x)
    assert torch.equal(b, 2 * x) and calls == [1, 1]


def test_insert_before_type() -> None:
    chain = fl.Chain(fl.Linear(2, 2), fl.SiLU(), fl.Linear(2, 2))
    chain.insert_before_type(fl.SiLU, fl.Sigmoid())
    assert [type(m).__name__ for m in chain] == ["Linear", "Sigmoid", "SiLU", "Linear"]
    with pytest.raises(ValueError, match="ReLU"):
        chain.insert_before_type(fl.ReLU, fl.Identity())


# -- fluxion.utils --------------------------------------------------------


@pytest.mark.parametrize("kernel_size, sigma", [(5, None), (3, 0.8), ((3, 7), (0.5, 2.0))])
def test_gaussian_blur_matches_jax(kernel_size: Any, sigma: Any) -> None:
    x = np.random.RandomState(5).rand(2, 11, 9, 3).astype(np.float32)
    want = np.asarray(jutils.gaussian_blur(jnp.asarray(x), kernel_size, sigma))
    got = nchw_to_nhwc(utils.gaussian_blur(torch.tensor(nhwc_to_nchw(x)), kernel_size, sigma).numpy())
    assert _rel(got, want) <= TOL
    assert utils.gaussian_blur(torch.rand(1, 1, 6, 6, dtype=torch.bfloat16), 3).dtype == torch.bfloat16


def test_norm_and_no_grad_match_jax() -> None:
    x = np.random.RandomState(6).randn(2, 3, 4).astype(np.float32)
    assert abs(float(utils.norm(torch.tensor(x))) - float(jutils.norm(jnp.asarray(x)))) <= TOL * float(np.linalg.norm(x))
    w = torch.ones(2, requires_grad=True)
    with utils.no_grad():
        assert not (w * 2).requires_grad
    assert (w * 2).requires_grad


def test_summarize_tensor_matches_jax() -> None:
    x = np.random.RandomState(7).randn(3, 5).astype(np.float32)
    assert utils.summarize_tensor(torch.tensor(x)) == jutils.summarize_tensor(jnp.asarray(x))
    assert utils.summarize_tensor(torch.zeros(0, 2)) == jutils.summarize_tensor(jnp.zeros((0, 2)))
    assert "grad=True" in utils.summarize_tensor(torch.ones(2, requires_grad=True))


def test_safetensors_round_trip(tmp_path: Any) -> None:
    tensors = {"a.weight": torch.randn(3, 4), "b": torch.arange(6, dtype=torch.int64), "c": torch.randn(2).bfloat16()}
    path = tmp_path / "t.safetensors"
    utils.save_to_safetensors(path, tensors, metadata={"format": "pt"})
    loaded = utils.load_from_safetensors(path)
    assert sorted(loaded) == sorted(tensors) and all(torch.equal(loaded[k], v) for k, v in tensors.items())
    with utils.safe_open(path) as f:
        assert f.metadata() == {"format": "pt"} and torch.equal(f.get_tensor("b"), tensors["b"])
    # the JAX package reads the file the port wrote (bf16 widened by numpy's lack of it)
    jax_loaded = jutils.load_from_safetensors(path)
    np.testing.assert_array_equal(np.asarray(jax_loaded["a.weight"]), tensors["a.weight"].numpy())


def test_load_tensors_keeps_nested_dicts(tmp_path: Any) -> None:
    state = {"string_to_param": {"*": torch.randn(2, 8)}, "step": torch.tensor(3)}
    torch.save(state, tmp_path / "emb.pt")
    loaded = utils.load_tensors(tmp_path / "emb.pt")
    assert torch.equal(loaded["string_to_param"]["*"], state["string_to_param"]["*"])
    want = jutils.load_tensors(tmp_path / "emb.pt")
    np.testing.assert_array_equal(np.asarray(want["string_to_param"]["*"]), loaded["string_to_param"]["*"].numpy())


def test_device_has_bfloat16() -> None:
    assert utils.device_has_bfloat16("cpu") is True
    if not torch.cuda.is_available():
        assert utils.device_has_bfloat16() is False
