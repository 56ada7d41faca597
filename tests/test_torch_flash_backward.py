"""The port's flash attention forward (with bias and logsumexp) and backward
against the JAX package, on the CPU.

The port's entries run their plain versions on CPU tensors; the JAX side
runs its Pallas kernels through the interpreter (as
tests/fluxion/test_flash_packed.py does): K2 (`_flash_forward`), K1
(`_flash_forward_packed`) and K4 (`_flash_backward`, through `jax.vjp`).
The kernels themselves run only on the card: see
tests/test_torch_flash_kernel.py, and the card tests at the end of this
file (the backward at 128 < d <= 512), which the card's machine runs
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_backward.py -q
"""

from __future__ import annotations

from typing import Any

import numpy as np
import pytest
import torch

from refiners_tpu_torch.ops import flash_attention as fa
from refiners_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads
from refiners_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_plain,
)

try:
    import jax
    import jax.numpy as jnp

    from refiners_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
    from refiners_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
    from refiners_tpu.ops.flash_attention import flash_attention as jax_flash_attention
    from refiners_tpu.ops.flash_attention import flash_attention_packed as jax_flash_attention_packed
except ImportError:  # the card's machine has no JAX: only the card tests below run there
    pass

# float32 on both sides; the Pallas kernels' online softmax and the port's
# dense softmax sum in different orders (≈1e-7 per element)
TOL = 1e-5
LSE_TOL = 1e-5
# autograd of the same plain version, on the same tensors
AUTOGRAD_TOL = 1e-6

SHAPES = [
    # (batch, lq, lk, heads, dim, causal)
    (1, 200, 300, 8, 40, False),  # SD1.5 head width, ragged lengths
    (2, 256, 256, 4, 64, True),
    (1, 256, 256, 3, 160, False),  # wide heads
    (1, 256, 256, 2, 80, True),  # SD1.5's second training site's head width, causal
    (1, 200, 260, 2, 128, False),  # the widest head of the narrow kernels, Lq != Lk
]
# biases broadcast to (2, 3, 192, 224) by stride 0: over heads, and a key
# bias over batch, heads and rows
BROADCAST_BIASES = [(2, 1, 192, 224), (1, 1, 1, 224)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads() -> Any:
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want)))


def _inputs(batch: int, lq: int, lk: int, heads: int, dim: int, seed: int) -> list[np.ndarray]:
    """q, k, v and an output gradient, (B, H, L, D) float32."""
    rs = np.random.RandomState(seed)
    return [rs.randn(batch, heads, n, dim).astype(np.float32) for n in (lq, lk, lk, lq)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("batch,lq,lk,heads,dim,causal", SHAPES)
def test_forward_and_lse_match_jax(
    batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool, with_bias: bool
) -> None:
    q, k, v, _ = _inputs(batch, lq, lk, heads, dim, seed=lq + dim)
    bias = np.random.RandomState(1).randn(batch, heads, lq, lk).astype(np.float32) if with_bias else None
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jbias = None if bias is None else jnp.asarray(bias)
    want = jax_flash_attention(jq, jk, jv, bias=jbias, is_causal=causal)
    _, want_lse = jax_flash_forward(jq, jk, jv, jbias, causal, None, with_lse=True)
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    tbias = None if bias is None else torch.tensor(bias)
    got = flash_attention(tq, tk, tv, bias=tbias, is_causal=causal)
    assert torch.equal(got, flash_attention_plain(tq, tk, tv, bias=tbias, is_causal=causal))
    _, lse = flash_attention_forward(tq, tk, tv, tbias, is_causal=causal, with_lse=True)
    assert got.shape == (batch, heads, lq, dim) and lse is not None and lse.shape == (batch, heads, lq)
    assert _rel(got.numpy(), want) <= TOL
    # the JAX lse is lane-broadcast (B, H, Lq_pad, 128): its first lane, first Lq rows
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)[:, :, :lq, 0]).max()) <= LSE_TOL


@pytest.mark.parametrize("bias_shape", BROADCAST_BIASES)
def test_forward_and_lse_with_a_broadcast_bias_match_jax(bias_shape: tuple[int, ...]) -> None:
    """The port takes the bias as given and broadcasts it by stride 0; the
    JAX kernel takes it materialized at (B, H, Lq, Lk). out within TOL, lse
    within LSE_TOL."""
    q, k, v, _ = _inputs(2, 192, 224, 3, 40, seed=len(bias_shape) + bias_shape[1])
    bias = np.random.RandomState(2).randn(*bias_shape).astype(np.float32)
    full = jnp.asarray(np.broadcast_to(bias, (2, 3, 192, 224)))
    want, want_lse = jax_flash_forward(*(jnp.asarray(x) for x in (q, k, v)), full, False, None, with_lse=True)
    got, lse = flash_attention_forward(*(torch.tensor(x) for x in (q, k, v)), torch.tensor(bias), with_lse=True)
    assert lse is not None and lse.shape == (2, 3, 192)
    assert _rel(got.numpy(), want) <= TOL
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)[:, :, :192, 0]).max()) <= LSE_TOL


def test_boolean_mask_with_a_fully_masked_row_gives_uniform_weights() -> None:
    """`use_flash=True` turns a boolean keep-mask into a -1e30 bias: a row
    with every key masked gets uniform weights (the plain path gives NaN).

    Lk is a multiple of 128 here: the JAX kernel's uniform weights run over
    its key block padded to 128 lanes (so with Lk = 160 it gives
    sum(V) / 256), where the port's kernel and plain version exclude the
    key tail and give mean(V) at any Lk."""
    q, k, v, _ = _inputs(1, 128, 256, 2, 32, seed=3)
    mask = np.random.RandomState(4).rand(1, 1, 128, 256) > 0.5
    mask[..., 5, :] = False
    want = np.asarray(
        jax_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask), use_flash=True)
    )
    got = dot_product_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), mask=torch.tensor(mask), use_flash=True)
    uniform = v.mean(axis=2)
    assert _rel(want[:, :, 5], uniform) <= TOL
    assert _rel(got.numpy()[:, :, 5], uniform) <= TOL
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("entry", ["packed", "flat"])
@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal",
    SHAPES
    + [(1, 300, 200, 2, 64, True), (1, 330, 200, 2, 128, True), (1, 200, 330, 2, 80, True)]
    # the wide heads of the VAEs' mid-block: d = 256 causal, d = 512 with Lq != Lk
    + [(1, 192, 192, 2, 256, True), (1, 160, 224, 1, 512, False)],
)
def test_backward_plain_matches_jax_vjp(
    entry: str, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool
) -> None:
    """`flash_attention_backward_plain` against `jax.vjp` of the JAX entries:
    packed d = 40 takes K2 + K4, packed d = 64 K1 + K4, flat K2 + K4. With
    Lq > Lk under `causal`, rows without an admissible key get zero dq."""
    q, k, v, do = _inputs(batch, lq, lk, heads, dim, seed=lq + 2 * dim)
    if entry == "packed":
        packed = [np.asarray(merge_heads(torch.tensor(x))) for x in (q, k, v, do)]

        def jax_fn(a: jax.Array, b: jax.Array, c: jax.Array) -> jax.Array:
            return jax_flash_attention_packed(a, b, c, is_causal=causal, head_dim=dim)

        _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in packed[:3]))
        want = [np.asarray(split_heads(torch.tensor(np.asarray(g)), heads)) for g in vjp(jnp.asarray(packed[3]))]
    else:
        _, vjp = jax.vjp(
            lambda a, b, c: jax_flash_attention(a, b, c, is_causal=causal), *(jnp.asarray(x) for x in (q, k, v))
        )
        want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = flash_attention_forward(tq, tk, tv, is_causal=causal, with_lse=True)
    assert lse is not None
    got = flash_attention_backward_plain(tq, tk, tv, out, lse, tdo, is_causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TOL
    # CPU tensors: the backward entry runs its plain version
    for g, h in zip(got, flash_attention_backward(tq, tk, tv, out, lse, tdo, is_causal=causal)):
        assert torch.equal(g, h)
    if causal and lq > lk:
        assert float(got[0][:, :, : lq - lk].abs().max()) == 0.0
        assert float(np.abs(want[0][:, :, : lq - lk]).max()) == 0.0


@pytest.mark.parametrize(
    "entry,causal,with_bias", [("packed", False, False), ("packed", True, False), ("flat", True, False), ("flat", False, True)]
)
def test_autograd_on_cpu_tensors_is_autograd_of_the_plain_version(entry: str, causal: bool, with_bias: bool) -> None:
    q, k, v, do = (torch.tensor(x) for x in _inputs(2, 96, 112, 3, 40, seed=11))
    bias = torch.tensor(np.random.RandomState(12).randn(2, 1, 96, 112).astype(np.float32)) if with_bias else None
    leaves = [x.requires_grad_() for x in (q, k, v) + ((bias,) if bias is not None else ())]
    if entry == "packed":
        pq, pk, pv = (merge_heads(x) for x in (q, k, v))
        got_out = split_heads(flash_attention_packed(pq, pk, pv, is_causal=causal, head_dim=40), 3)
    else:
        got_out = flash_attention(q, k, v, bias=bias, is_causal=causal)
    got = torch.autograd.grad(got_out, leaves, do)
    want = torch.autograd.grad(flash_attention_plain(q, k, v, bias=bias, is_causal=causal), leaves, do)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= AUTOGRAD_TOL


# -- on the card: the backward kernels at 128 < d <= 512 ------------------------------

# bf16 unit roundoff is 3.9e-3; the kernels round P and dS once each and sum
# over a whole sequence, the plain version runs in float32 from the same inputs
GRAD_TOL = 2e-2
# the float32 kernels against the float32 plain version: summation order only
F32_TOL = 1e-5
WIDE_SHAPES = [
    # (batch, lq, lk, heads, dim, causal)
    (1, 256, 320, 2, 136, False),  # padded to 256
    (1, 300, 260, 1, 200, True),  # d not a multiple of 16; causal with Lq > Lk
    (2, 256, 256, 2, 256, False),
    (1, 1000, 1100, 1, 512, True),  # ragged and causal
    (2, 1024, 1024, 1, 512, False),  # the SD1.5 VAE's mid-block at 32×32 latents
    (2, 4096, 4096, 1, 512, False),  # at 64×64 latents (a 512² image): phase 4c's training site
    (1, 72, 24, 1, 512, True),  # no length a multiple of 32, Lk < 32; 48 query rows without a key
    (1, 330, 200, 2, 256, False),  # Lq != Lk, both ending mid-tile
]


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


def _check_wide_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, seed: int) -> None:
    """The forward with lse, then one launch of each backward kernel, held
    against `flash_attention_backward_plain` in float32 on the same inputs."""
    gen = torch.Generator(q.device).manual_seed(seed)
    out, lse = flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
    assert lse is not None
    do = torch.randn(out.shape, generator=gen, device=q.device).to(q.dtype)
    launches = (fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches)  # type: ignore[attr-defined]
    got = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dkv.launches, fa.flash_attention_bwd_dq.launches) == (  # type: ignore[attr-defined]
        launches[0] + 1,
        launches[1] + 1,
    )
    want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float(), is_causal=causal)
    tol = F32_TOL if q.dtype == torch.float32 else GRAD_TOL
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == q.dtype
        assert bool(torch.isfinite(g).all()), name
        assert _card_rel(g, w) <= tol, (name, _card_rel(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("batch,lq,lk,heads,dim,causal", WIDE_SHAPES)
def test_wide_backward_kernels_match_plain(
    card: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool, dtype: torch.dtype
) -> None:
    gen = torch.Generator(card).manual_seed(lq + lk + dim)
    q, k, v = (torch.randn((batch, heads, n, dim), generator=gen, device=card).to(dtype) for n in (lq, lk, lk))
    assert fa.backward_kernels(dtype, dim) == (
        ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")
        if dtype == torch.float32
        else ("flash_bwd_wide_wgmma_kernel",) * 2
    )
    _check_wide_backward(q, k, v, causal, seed=dim)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dim", [8, 40, 64, 80, 128, 136, 200, 256, 264, 512])
def test_backward_kernels_route_by_head_dim(dtype: torch.dtype, dim: int) -> None:
    """The narrow dK/dV and dQ kernels up to d = 128, the wide wgmma kernel
    for both entries above (the routing the C entries apply)."""
    want = (
        ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel") if dim <= 128 else ("flash_bwd_wide_wgmma_kernel",) * 2
    )
    assert fa.backward_kernels(dtype, dim) == want


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lq,lk,heads,dim,causal", [(2, 4096, 4096, 1, 512, False), (1, 1000, 1100, 1, 512, True)])
def test_wide_backward_is_deterministic(
    card: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool
) -> None:
    """Two runs of the wide backward on the same inputs give the same bits
    (no atomics: every gradient element is summed by one block in one
    order), which the training harness's resume check relies on."""
    gen = torch.Generator(card).manual_seed(lq + dim)
    q, k, v = (torch.randn((batch, heads, n, dim), generator=gen, device=card).bfloat16() for n in (lq, lk, lk))
    out, lse = flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
    assert lse is not None
    do = torch.randn(out.shape, generator=gen, device=card).bfloat16()
    first = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    second = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_backward_reads_heads_through_strides(card: torch.device, dtype: torch.dtype) -> None:
    """q, k, v as column slices of one fused (1, 1024, 3·512) projection."""
    gen = torch.Generator(card).manual_seed(7)
    qkv = torch.randn((1, 1024, 3 * 512), generator=gen, device=card).to(dtype)
    q, k, v = (split_heads(qkv[..., i * 512 : (i + 1) * 512], 1) for i in range(3))
    _check_wide_backward(q, k, v, causal=False, seed=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_through_the_packed_entry_at_d512(card: torch.device, dtype: torch.dtype) -> None:
    """`flash_attention_packed` under autograd at one head of d = 512 (the VAE
    mid-block's): one forward with lse and one launch of each backward
    kernel, the gradients against autograd of the float32 plain version."""
    gen = torch.Generator(card).manual_seed(9)
    q, k, v, g = (torch.randn((2, 1024, 512), generator=gen, device=card).to(dtype) for _ in range(4))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    counters = (fa.flash_attention, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)
    before = [c.launches for c in counters]  # type: ignore[attr-defined]
    got = torch.autograd.grad(flash_attention_packed(q, k, v, head_dim=512), leaves, g)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1]  # type: ignore[attr-defined]
    ref = [x.detach().float().requires_grad_() for x in leaves]
    want = torch.autograd.grad(flash_attention_packed_plain(*ref, head_dim=512), ref, g.float())
    tol = F32_TOL if dtype == torch.float32 else GRAD_TOL
    for a, b in zip(got, want):
        assert _card_rel(a, b) <= tol
