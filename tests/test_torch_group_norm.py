"""The port's fused GroupNorm(+SiLU) (K5a, K5b) against the JAX package, on the CPU.

The port's `group_norm_silu` runs its plain version on CPU tensors (two-pass
float32 statistics), and `group_norm_stats` / `group_norm_apply` run the
plain versions of the two kernels (chunked sums shifted by a pivot, then the
merge and the affine fold). The JAX side runs `group_norm_silu` through the
Pallas interpreter, as tests/fluxion/test_group_norm_fusion.py does, and its
`_xla_reference`. The JAX functions take channels-last (B, …, C); the port
NCHW, so the tests transpose at the boundary. The kernels themselves run
only on the card: see tests/test_torch_passes_kernel.py.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from refiners_tpu.ops.group_norm import _xla_reference
from refiners_tpu.ops.group_norm import group_norm_silu as jax_group_norm_silu
from refiners_tpu_torch.conversion import nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.ops import group_norm as gn

# float32 on both sides: summation order only
ATOL = 1e-5
# bf16 outputs: one rounding of values of order 1 (unit roundoff 3.9e-3), as the JAX test allows
BF16_ATOL = 2e-2
# gradients recomputed through autograd of the plain version on both sides
GRAD_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(shape: tuple[int, ...], seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Channels-last x (mean 0.5, std 2), weight and bias, from a seed."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    return x, (rs.randn(c) * 0.2 + 1.0).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32)


def _port(*arrays: np.ndarray) -> list[torch.Tensor]:
    x, *rest = arrays
    return [torch.tensor(nhwc_to_nchw(x)), *(torch.tensor(a) for a in rest)]


def _kernels_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int, **kw: Any) -> torch.Tensor:
    """K5a then K5b, each through its plain version (what the card computes)."""
    return gn.group_norm_apply(x, gn.group_norm_stats(x, groups), w, b, groups, **kw)


@pytest.mark.parametrize(
    "shape,groups",
    [
        ((2, 16, 16, 320), 32),  # SD's top level: C/G = 10
        ((1, 8, 8, 1280), 32),  # SDXL's bottom level
        ((1, 7, 9, 64), 8),  # odd spatial, small C
        ((2, 5, 6, 96), 32),  # 90-element groups: unaligned chunk starts on the card
    ],
)
def test_group_norm_silu_matches_jax(shape: tuple[int, ...], groups: int) -> None:
    x, w, b = _operands(shape, seed=sum(shape))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_group_norm_silu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups))
    reference = np.asarray(_xla_reference(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups, 1e-5, True))
    xt, wt, bt = _port(x, w, b)
    for got in (gn.group_norm_silu(xt, wt, bt, groups), _kernels_plain(xt, wt, bt, groups)):
        got = nchw_to_nhwc(got.numpy())
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, reference, atol=ATOL)


def test_group_norm_without_silu_matches_jax() -> None:
    x, w, b = _operands((1, 6, 10, 128), seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_group_norm_silu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-6, False))
    xt, wt, bt = _port(x, w, b)
    for got in (
        gn.group_norm_silu(xt, wt, bt, 32, eps=1e-6, apply_silu=False),
        _kernels_plain(xt, wt, bt, 32, eps=1e-6, apply_silu=False),
    ):
        np.testing.assert_allclose(nchw_to_nhwc(got.numpy()), want, atol=ATOL)


def test_group_norm_silu_bf16_matches_jax() -> None:
    x = (np.random.RandomState(4).randn(1, 16, 16, 128) * 3).astype(np.float32)
    w, b = np.ones(128, np.float32), np.zeros(128, np.float32)
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_group_norm_silu(xj, wj, bj, 32), np.float32)
    reference = np.asarray(_xla_reference(xj, wj, bj, 32, 1e-5, True), np.float32)
    xt, wt, bt = (t.bfloat16() for t in _port(x, w, b))
    for got in (gn.group_norm_silu(xt, wt, bt, 32), _kernels_plain(xt, wt, bt, 32)):
        assert got.dtype == torch.bfloat16
        got = nchw_to_nhwc(got.float().numpy())
        np.testing.assert_allclose(got, want, atol=BF16_ATOL)
        np.testing.assert_allclose(got, reference, atol=BF16_ATOL)


def test_group_norm_silu_gradients_match_jax() -> None:
    """The autograd wrapper (the kernels' backward on the card) against the
    JAX `custom_vjp`, for x, weight and bias."""
    x, w, b = _operands((1, 4, 4, 32), seed=5)
    loss = lambda *a: jnp.sum(jnp.sin(jax_group_norm_silu(*a, 8)))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (t.requires_grad_() for t in _port(x, w, b))
    torch.sin(gn._GroupNormSiLU.apply(xt, wt, bt, 8, 1e-5, True)).sum().backward()
    got = [nchw_to_nhwc(xt.grad.numpy()), wt.grad.numpy(), bt.grad.numpy()]
    for g, e, name in zip(got, want, ("x", "weight", "bias")):
        np.testing.assert_allclose(g, np.asarray(e), atol=GRAD_ATOL, err_msg=f"d{name}")
    # the public entry takes the same route under grad
    xt2 = xt.detach().clone().requires_grad_()
    torch.sin(gn.group_norm_silu(xt2, wt, bt, 8)).sum().backward()
    np.testing.assert_allclose(nchw_to_nhwc(xt2.grad.numpy()), got[0], atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shifted_statistics_hold_a_large_mean(dtype: torch.dtype) -> None:
    """The kernels' statistics are sums shifted by each slab's first element,
    over several chunks: float32-accurate where E[x²] − E[x]² (the JAX
    kernel's single pass) loses the variance to cancellation."""
    rs = np.random.RandomState(6)
    x = torch.tensor(1000.0 + rs.randn(1, 4, 150, 150)).to(dtype)  # 22,500 elements per group: 2-3 chunks
    w, b = torch.ones(4), torch.zeros(4)
    partials = gn.group_norm_stats(x, 2)
    assert partials.shape == (2, -(-2 * 22500 // gn.chunk_len(dtype)), 2)
    x64 = x.double().reshape(2, -1)
    want = ((x64 - x64.mean(-1, keepdim=True)) / torch.sqrt(x64.var(-1, correction=0, keepdim=True) + 1e-5)).reshape(x.shape)
    got = gn.group_norm_apply(x.float(), gn.group_norm_stats(x.float(), 2), w, b, 2, apply_silu=False).double()
    assert float((got - want).abs().max()) < 1e-3
    single_pass_var = (x64.float() ** 2).mean(-1) - x64.float().mean(-1) ** 2
    assert float((single_pass_var - x64.var(-1, correction=0)).abs().max()) > 1e-2  # what the shift avoids


def test_kernel_input_checks() -> None:
    """What the CUDA wrappers refuse before a launch (checked here on CPU tensors)."""
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        gn._check_input(torch.zeros((1, 32, 4, 4), dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="contiguous"):
        gn._check_input(torch.zeros((1, 4, 4, 32)).permute(0, 3, 1, 2), 8)
    with pytest.raises(ValueError, match="divisible"):
        gn._check_input(torch.zeros((1, 30, 4, 4)), 8)
    gn._check_input(torch.zeros((2, 96, 5, 6), dtype=torch.bfloat16), 32)
    assert gn.chunk_len(torch.bfloat16) == 16384 and gn.chunk_len(torch.float32) == 8192
