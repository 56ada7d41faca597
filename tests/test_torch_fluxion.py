"""The port's fluxion layers and combinators against the JAX package, on the CPU.

Weights are random (numpy, seeded), set on the JAX module and bridged into
the port with `load_jax_state_dict`; inputs are numpy arrays handed to both.
Spatial tensors are NHWC on the JAX side and NCHW in the port.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.fluxion.adapters.adapter import Adapter as JaxAdapter
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.fluxion.adapters.adapter import Adapter

# float32 on both sides; only the summation order differs (≈1e-7 per op)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridge(jax_module: Any, port_module: torch.nn.Module, seed: int = 0) -> None:
    """Randomize the JAX module's weights, then load them into the port."""
    rs = np.random.RandomState(seed)
    state = {k: rs.randn(*v.shape).astype(np.float32) * 0.3 for k, v in jax_module.state_dict().items()}
    jax_module.load_state_dict(state)
    load_jax_state_dict(port_module, {k: np.asarray(v) for k, v in jax_module.state_dict().items()})


def _run_both(jax_module: Any, port_module: torch.nn.Module, *inputs: np.ndarray, spatial: bool) -> tuple[Any, Any]:
    with torch.no_grad():
        got = port_module(*(torch.tensor(nhwc_to_nchw(x) if spatial else x) for x in inputs))
    want = jax_module(*(jnp.asarray(x) for x in inputs))
    return got, want


def _as_numpy(x: Any, spatial: bool) -> np.ndarray:
    arr = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return nchw_to_nhwc(arr) if spatial and isinstance(x, torch.Tensor) else arr


LEAF_CASES: dict[str, tuple[Callable[[Any], Any], tuple[int, ...], bool]] = {
    # name: (builder given the fl namespace, input shape on the JAX side, spatial)
    "linear": (lambda ns: ns.Linear(32, 48), (2, 5, 32), False),
    "linear_no_bias": (lambda ns: ns.Linear(32, 16, bias=False), (3, 32), False),
    "conv3x3": (lambda ns: ns.Conv2d(8, 16, kernel_size=3, padding=1), (2, 9, 9, 8), True),
    "conv_strided": (lambda ns: ns.Conv2d(8, 8, kernel_size=3, stride=2, padding=1), (2, 9, 9, 8), True),
    "group_norm": (lambda ns: ns.GroupNorm(channels=64, num_groups=32, eps=1e-6), (2, 6, 6, 64), True),
    "layer_norm": (lambda ns: ns.LayerNorm(32), (2, 5, 32), False),
    "downsample_vae_pad": (
        lambda ns: ns.Downsample(channels=8, scale_factor=2, register_shape=False),
        (1, 9, 9, 8),
        True,
    ),
    "upsample_factor": (lambda ns: ns.Upsample(channels=8, upsample_factor=2), (1, 5, 7, 8), True),
}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaf_layer_matches_jax(case: str) -> None:
    build, shape, spatial = LEAF_CASES[case]
    jax_module, port_module = build(jfl), build(fl)
    _bridge(jax_module, port_module)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got, want = _run_both(jax_module, port_module, x, spatial=spatial)
    got = _as_numpy(got, spatial)
    assert got.shape == np.asarray(want).shape
    assert _rel(got, np.asarray(want)) <= TOL


def test_downsample_upsample_share_the_sampling_context() -> None:
    """Upsample without a factor restores the shape Downsample registered."""
    chains = []
    for ns in (jfl, fl):
        chain = ns.Chain(ns.Downsample(channels=8, scale_factor=2, padding=1), ns.Upsample(channels=8))
        chain.set_context("sampling", {"shapes": []})
        chains.append(chain)
    _bridge(chains[0], chains[1])
    x = np.random.RandomState(2).randn(1, 7, 7, 8).astype(np.float32)
    got, want = _run_both(chains[0], chains[1], x, spatial=True)
    assert got.shape == (1, 8, 7, 7)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= TOL


COMBINATOR_CASES: dict[str, tuple[Callable[[Any], Any], int]] = {
    # name: (builder given the fl namespace, number of inputs)
    "sum": (lambda ns: ns.Sum(ns.Linear(16, 8), ns.Linear(16, 8)), 1),
    "residual": (lambda ns: ns.Residual(ns.Linear(16, 16), ns.SiLU()), 1),
    "parallel": (lambda ns: ns.Parallel(ns.Linear(16, 8), ns.Chain(ns.Linear(16, 4), ns.GeLU())), 1),
    "distribute": (lambda ns: ns.Distribute(ns.Linear(16, 8), ns.Linear(16, 8)), 2),
    "concatenate": (lambda ns: ns.Concatenate(ns.Linear(16, 8), ns.Linear(16, 4), dim=-1), 1),
}


@pytest.mark.parametrize("case", list(COMBINATOR_CASES))
def test_combinator_matches_jax(case: str) -> None:
    build, n_inputs = COMBINATOR_CASES[case]
    jax_module, port_module = build(jfl), build(fl)
    _bridge(jax_module, port_module)
    assert list(port_module.state_dict()) == list(jax_module.state_dict())
    rs = np.random.RandomState(3)
    inputs = [rs.randn(4, 16).astype(np.float32) for _ in range(n_inputs)]
    got, want = _run_both(jax_module, port_module, *inputs, spatial=False)
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    assert len(got_t) == len(want_t)
    for g, w in zip(got_t, want_t):
        assert _rel(g.numpy(), np.asarray(w)) <= TOL


def test_set_and_use_context_match_jax() -> None:
    """SetContext stores a value mid-chain; a later UseContext reads it back."""
    chains = []
    for ns in (jfl, fl):
        chain = ns.Chain(
            ns.Linear(16, 16),
            ns.SetContext("scratch", "h"),
            ns.SiLU(),
            ns.Sum(ns.Linear(16, 16), ns.UseContext("scratch", "h")),
        )
        chain.set_context("scratch", {"h": None})
        chains.append(chain)
    _bridge(chains[0], chains[1])
    x = np.random.RandomState(4).randn(2, 16).astype(np.float32)
    got, want = _run_both(chains[0], chains[1], x, spatial=False)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_chain_slicing_matches_jax_and_shares_weights() -> None:
    chains = [ns.Chain(ns.Linear(8, 16), ns.SiLU(), ns.Linear(16, 16), ns.Linear(16, 4)) for ns in (jfl, fl)]
    _bridge(chains[0], chains[1])
    jax_slice, port_slice = chains[0][1:3], chains[1][1:3]
    assert list(port_slice.state_dict()) == list(jax_slice.state_dict()) == ["Linear.weight", "Linear.bias"]
    assert port_slice.Linear.weight is chains[1].Linear_2.weight
    assert port_slice.parent is None and chains[1].Linear_2 in chains[1]
    x = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    got, want = _run_both(jax_slice, port_slice, x, spatial=False)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


class _JaxWrap(jfl.Chain, JaxAdapter[jfl.Linear]):
    def __init__(self, target: jfl.Linear) -> None:
        with self.setup_adapter(target):
            super().__init__(target, jfl.SiLU())


class _PortWrap(fl.Chain, Adapter[fl.Linear]):
    def __init__(self, target: fl.Linear) -> None:
        with self.setup_adapter(target):
            super().__init__(target, fl.SiLU())


def test_adapter_inject_eject_matches_jax() -> None:
    chains = [ns.Chain(ns.Linear(8, 8), ns.SiLU(), ns.Linear(8, 8)) for ns in (jfl, fl)]
    _bridge(chains[0], chains[1])
    x = np.random.RandomState(6).randn(2, 8).astype(np.float32)
    _, base = _run_both(chains[0], chains[1], x, spatial=False)
    with torch.no_grad():
        port_base = chains[1](torch.tensor(x))

    _JaxWrap(chains[0].Linear_2).inject(chains[0])
    port_adapter = _PortWrap(chains[1].Linear_2).inject(chains[1])
    assert list(chains[0].state_dict())[2:] == ["_JaxWrap.Linear.weight", "_JaxWrap.Linear.bias"]
    assert list(chains[1].state_dict())[2:] == ["_PortWrap.Linear.weight", "_PortWrap.Linear.bias"]
    got, want = _run_both(chains[0], chains[1], x, spatial=False)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    assert not np.allclose(got.numpy(), np.asarray(base))

    port_adapter.eject()
    with torch.no_grad():
        after = chains[1](torch.tensor(x))
    assert torch.equal(after, port_base)
    assert list(chains[1].state_dict()) == ["Linear_1.weight", "Linear_1.bias", "Linear_2.weight", "Linear_2.bias"]
