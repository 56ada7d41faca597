"""The port's attention against the JAX package, on the CPU.

`flash_attention_packed` on CPU tensors runs its plain version; it is held
against the JAX `flash_attention_packed`, which runs its Pallas kernel
through the interpreter here (as tests/fluxion/test_flash_packed.py does).
The kernel itself runs only on the card: see tests/test_torch_flash_kernel.py.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import refiners_tpu.fluxion.layers as jfl
import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu.ops.attention import force_flash
from refiners_tpu.ops.flash_attention import flash_attention_packed as jax_flash_attention_packed
from refiners_tpu_torch.conversion import load_jax_state_dict, nchw_to_nhwc, nhwc_to_nchw
from refiners_tpu_torch.fluxion.layers import attentions
from refiners_tpu_torch.ops.attention import flash_auto
from refiners_tpu_torch.ops.flash_attention import flash_attention_packed

# float32 on both sides; the online softmax of the Pallas kernel and the
# port's dense softmax sum in different orders (≈1e-7 per element)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _qkv(batch: int, lq: int, lk: int, width: int, seed: int) -> list[np.ndarray]:
    rs = np.random.RandomState(seed)
    return [rs.randn(batch, n, width).astype(np.float32) for n in (lq, lk, lk)]


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal",
    [
        (2, 256, 320, 4, 64, False),
        (1, 200, 300, 8, 40, False),  # SD1.5 head width, ragged lengths
        (1, 256, 256, 1, 512, False),  # the VAE's single wide head
        (2, 256, 256, 4, 64, True),
        # the widths the card's wide-head kernel pads: d = 256, d = 512 with
        # a mask, d = 200 (pads to 256; the JAX entry takes its flat fallback)
        (1, 192, 320, 1, 256, False),
        (1, 256, 256, 1, 512, True),
        (2, 130, 150, 2, 200, False),
        # the card's narrow kernel: d = 80 (a 64-column box and a 16-column
        # box) causal with Lq != Lk, neither a multiple of 128; d = 128 ragged
        (1, 200, 330, 3, 80, True),
        (2, 300, 260, 2, 128, False),
    ],
)
def test_flash_attention_packed_matches_jax(batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool) -> None:
    q, k, v = _qkv(batch, lq, lk, heads * dim, seed=lq + dim)
    want = jax_flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=causal, head_dim=dim)
    got = flash_attention_packed(torch.tensor(q), torch.tensor(k), torch.tensor(v), is_causal=causal, head_dim=dim)
    assert got.shape == (batch, lq, heads * dim)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


@pytest.mark.parametrize("causal", [False, True])
def test_scaled_dot_product_attention_layer_matches_jax(causal: bool) -> None:
    """The port's layer on its kernel route (slice_size set) against the JAX
    layer forced onto its flash kernel."""
    q, k, v = _qkv(2, 256, 256, 4 * 32, seed=7)
    jax_layer = jfl.ScaledDotProductAttention(num_heads=4, is_causal=causal)
    port_layer = fl.ScaledDotProductAttention(num_heads=4, is_causal=causal, slice_size=1)
    with force_flash():
        want = jax_layer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = port_layer(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert _rel(got.numpy(), np.asarray(want)) <= TOL


def test_self_attention_2d_matches_jax() -> None:
    """VAE-style single-head self-attention over a 32×32 map (seq 1024)."""
    jax_layer, port_layer = jfl.SelfAttention2d(channels=64), fl.SelfAttention2d(channels=64)
    rs = np.random.RandomState(8)
    jax_layer.load_state_dict({k: rs.randn(*a.shape).astype(np.float32) * 0.2 for k, a in jax_layer.state_dict().items()})
    load_jax_state_dict(port_layer, {k: np.asarray(a) for k, a in jax_layer.state_dict().items()})
    x = rs.randn(1, 32, 32, 64).astype(np.float32)
    with force_flash():
        want = jax_layer(jnp.asarray(x))
    with torch.no_grad():
        got = port_layer(torch.tensor(nhwc_to_nchw(x)))
    assert got.shape == (1, 64, 32, 32)
    assert _rel(nchw_to_nhwc(got.numpy()), np.asarray(want)) <= TOL


def test_cpu_tensors_take_the_plain_version_and_launch_nothing() -> None:
    q, k, v = (torch.tensor(a) for a in _qkv(1, 64, 64, 128, seed=9))
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, head_dim=64)
    assert flash_attention_packed.launches == before
    assert out.shape == q.shape and out.device.type == "cpu"


def test_non_cpu_non_cuda_tensors_raise() -> None:
    """The wrapper falls back to the plain version only for CPU tensors."""
    q = torch.empty((1, 64, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_packed(q, q, q, head_dim=64)


def test_layer_routes_like_the_jax_layer(monkeypatch: pytest.MonkeyPatch) -> None:
    """slice_size forces the kernel route, is_optimized=False forbids it, and
    otherwise only long sequences on the card take it."""
    calls: list[int] = []

    def record(q: torch.Tensor, *args: Any, **kwargs: Any) -> torch.Tensor:
        calls.append(q.shape[1])
        return torch.zeros_like(q)

    monkeypatch.setattr(attentions, "flash_attention_packed", record)
    x = torch.randn(1, 1024, 64)
    fl.ScaledDotProductAttention(num_heads=1)(x, x, x)
    assert calls == []  # CPU tensors: plain path whatever the length
    fl.ScaledDotProductAttention(num_heads=1, slice_size=64)(x, x, x)
    assert calls == [1024]
    fl.ScaledDotProductAttention(num_heads=1, is_optimized=False, slice_size=64)(x, x, x)
    assert calls == [1024]
    assert not flash_auto(x, 4096, 4096)
