"""The port's relative-position flash forward (K3) and SAM's relative-position
attention against the JAX package, on the CPU.

The port's `flash_attention_relpos` runs its plain version on CPU tensors
(the O(L²) bias materialized); the JAX side runs `_flash_relpos_kernel`
through the Pallas interpreter, as tests/fluxion/test_flash_relpos.py does,
or its dense fallback where the JAX package takes it. The kernel itself
runs only on the card: see tests/test_torch_flash_kernel.py.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refiners_tpu.foundationals.segment_anything.image_encoder import (
    RelativePositionAttention as JaxRelativePositionAttention,
)
from refiners_tpu.ops.attention import force_flash
from refiners_tpu.ops.flash_attention import flash_attention_relpos as jax_flash_attention_relpos
from refiners_tpu_torch.conversion import load_jax_state_dict
from refiners_tpu_torch.foundationals.segment_anything.image_encoder import RelativePositionAttention
from refiners_tpu_torch.ops import attention as attention_ops
from refiners_tpu_torch.ops.flash_attention import flash_attention_relpos, flash_attention_relpos_plain

# float32 on both sides: the interpreted kernel's online softmax and the
# plain version's dense softmax sum in different orders
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(kh: int, kw: int, heads: int, d: int, seed: int) -> list[np.ndarray]:
    lq = lk = kh * kw
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(1, heads, n, d).astype(np.float32) for n in (lq, lk, lk))
    v_rel = (0.5 * rs.randn(1, heads, lq, kh)).astype(np.float32)
    h_rel = (0.5 * rs.randn(1, heads, lq, kw)).astype(np.float32)
    return [q, k, v, v_rel, h_rel]


@pytest.mark.parametrize(
    "kh,kw,heads,d",
    [
        (16, 16, 2, 64),  # the JAX kernel's whole-rows-per-tile branch
        (14, 14, 3, 80),  # SAM's windowed layers: one padded key block
        (10, 10, 1, 32),  # the JAX package falls back to its dense-bias kernel
        (12, 20, 2, 80),  # rectangular, kw does not divide 64: the card's counters wrap mid-tile
    ],
)
def test_relpos_plain_matches_jax(kh: int, kw: int, heads: int, d: int) -> None:
    arrays = _operands(kh, kw, heads, d, seed=kh + d)
    want = jax_flash_attention_relpos(*(jnp.asarray(a) for a in arrays), scale=d**-0.5)
    got = flash_attention_relpos_plain(*(torch.from_numpy(a) for a in arrays), scale=d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_relpos_entry_on_cpu_tensors_is_its_plain_version() -> None:
    tensors = [torch.from_numpy(a) for a in _operands(8, 12, 2, 32, seed=3)]
    before = flash_attention_relpos.launches  # type: ignore[attr-defined]
    got = flash_attention_relpos(*tensors)
    assert torch.equal(got, flash_attention_relpos_plain(*tensors))
    assert flash_attention_relpos.launches == before  # type: ignore[attr-defined]


@pytest.mark.parametrize("jax_flash", [False, True])
@pytest.mark.parametrize("port_route", ["plain", "kernel entry"])
def test_relative_position_attention_matches_jax(
    monkeypatch: pytest.MonkeyPatch, jax_flash: bool, port_route: str
) -> None:
    """A 16 × 16 layer with non-zero embeddings. The JAX layer runs its
    kernel (interpreted) or its plain branch; the port's runs its plain
    branch, or its kernel branch (views, scale and bias layout as on the
    card) through the entry's plain version."""
    jax_attn = JaxRelativePositionAttention(embedding_dim=64, num_heads=4, spatial_size=(16, 16))
    jax_attn.horizontal_embedding = jnp.asarray(np.random.RandomState(4).randn(31, 16).astype(np.float32))
    jax_attn.vertical_embedding = jnp.asarray(np.random.RandomState(5).randn(31, 16).astype(np.float32))
    attn = RelativePositionAttention(embedding_dim=64, num_heads=4, spatial_size=(16, 16))
    load_jax_state_dict(attn, {k: np.asarray(v) for k, v in jax_attn.state_dict().items()})
    x = np.random.RandomState(6).randn(1, 16, 16, 3 * 64).astype(np.float32)

    with force_flash(jax_flash):
        want = jax_attn(jnp.asarray(x))
    if port_route == "kernel entry":
        monkeypatch.setattr(attention_ops, "flash_auto_relpos", lambda _x: True)
    with torch.no_grad():
        got = attn(torch.from_numpy(x))
    assert got.shape == (1, 16, 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
