"""The hand-written flash attention kernels against their plain versions, on the card.

These tests need an NVIDIA card with nvcc (sm_90a) and skip elsewhere. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py -q
"""

from __future__ import annotations

import pytest
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.ops import flash_attention as fa
from refiners_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_plain,
)

pytestmark = pytest.mark.cuda

# bf16 unit roundoff is 3.9e-3 and the kernel rounds P and O once each; the
# plain version runs in float32 from the same bf16 inputs
TOL = 1e-2
# the backward rounds P and dS once each and sums over a whole sequence
GRAD_TOL = 2e-2
# lse is float32 throughout, from the same bf16 q and k: summation order only
LSE_TOL = 1e-3
# the float32 kernels against the float32 plain versions: summation order
# only (float32 unit roundoff 6e-8, sums over a few hundred terms)
F32_TOL = 1e-5
F32_LSE_TOL = 1e-5

COUNTERS = (fa.flash_attention_packed, fa.flash_attention, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq)


@pytest.fixture
def device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _qkv(device: torch.device, batch: int, lq: int, lk: int, width: int, dtype: torch.dtype) -> list[torch.Tensor]:
    gen = torch.Generator(device).manual_seed(lq * 7 + lk + width)
    return [torch.randn((batch, n, width), generator=gen, device=device).to(dtype) for n in (lq, lk, lk)]


def _qkv4(device: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int) -> list[torch.Tensor]:
    gen = torch.Generator(device).manual_seed(lq + 3 * lk + dim)
    return [torch.randn((batch, heads, n, dim), generator=gen, device=device).bfloat16() for n in (lq, lk, lk)]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


def _launches() -> list[int]:
    return [c.launches for c in COUNTERS]  # type: ignore[attr-defined]


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal,dtype",
    [
        (2, 256, 320, 4, 64, False, torch.bfloat16),
        (1, 200, 300, 8, 40, False, torch.bfloat16),  # head_dim not a multiple of 16
        (1, 256, 256, 1, 512, False, torch.bfloat16),
        (2, 256, 256, 4, 64, True, torch.bfloat16),
        (2, 1000, 1100, 5, 64, False, torch.bfloat16),
        (1, 4096, 4096, 10, 64, False, torch.float16),
        (3, 77, 77, 12, 64, True, torch.bfloat16),
        (1, 300, 260, 3, 128, False, torch.bfloat16),
        (2, 200, 200, 2, 80, True, torch.float16),
        (1, 130, 150, 2, 256, False, torch.bfloat16),  # between the two kernels' ranges
        (1, 200, 300, 8, 40, False, torch.float32),
        (2, 256, 256, 4, 64, True, torch.float32),
        (1, 130, 150, 2, 160, False, torch.float32),  # the D = 256 template
        (1, 256, 256, 1, 512, False, torch.float32),
        (1, 4096, 4096, 1, 512, False, torch.bfloat16),  # the wgmma kernel at a VAE mid-block of 64×64 latents
        # keys twice as long as the queries: StyleAligned (batch 4) and reference-only (batch 2) at 512²
        (4, 4096, 8192, 8, 40, False, torch.bfloat16),  # the 64² sites: 128 key tiles of 64 at d = 40
        (2, 1024, 2048, 8, 80, False, torch.bfloat16),  # the 32² sites
        # SDXL's batch-1 UNet calls (SAG's degraded pass, LCM, Lightning) and a 1024 × 2048 panorama's
        # decode: one head of d = 512 over 128 × 256 latents, 512 blocks of 64 rows
        (1, 4096, 4096, 10, 64, False, torch.bfloat16),
        (1, 1024, 1024, 20, 64, False, torch.bfloat16),
        (1, 32768, 32768, 1, 512, False, torch.bfloat16),
        # DINOv2-g at 518², batch 4, with and without its four registers: ragged on both sides
        # (1374 = 10·128 + 94), so no tail may read or write the next batch element's rows
        (4, 1374, 1374, 24, 64, False, torch.bfloat16),
        (4, 1370, 1370, 24, 64, False, torch.bfloat16),
        (4, 1374, 1374, 24, 64, False, torch.float32),
    ],
)
def test_kernel_matches_plain(
    device: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool, dtype: torch.dtype
) -> None:
    q, k, v = _qkv(device, batch, lq, lk, heads * dim, dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, is_causal=causal, head_dim=dim)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=causal, head_dim=dim)
    assert _rel(got, want) <= (F32_TOL if dtype == torch.float32 else TOL)


# every padded head dim of the narrow kernel (64, 80, 128) and the widths
# that pad into each: d = 8 and 40 run one or three of its four 16-column
# steps of Q K^T, d = 72 and 80 the 16-column box, d = 96 six of eight steps
NARROW_DIMS = [8, 40, 64, 72, 80, 96, 128]


@pytest.mark.parametrize("dim", [40, 64, 80, 128])
def test_kernel_reads_strided_heads(device: torch.device, dim: int) -> None:
    """Four heads as column slices of one fused projection (row stride
    3·4·d), read in place by the narrow kernel's tensor maps; TOL (1e-2)."""
    width = 4 * dim
    qkv = torch.randn((2, 512, 3 * width), generator=torch.Generator(device).manual_seed(dim), device=device).bfloat16()
    q, k, v = qkv[..., :width], qkv[..., width : 2 * width], qkv[..., 2 * width :]
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, head_dim=dim)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), head_dim=dim)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("dim", NARROW_DIMS)
def test_causal_rows_without_keys_get_uniform_weights(device: torch.device, dim: int) -> None:
    """Causal with Lq > Lk: the first Lq - Lk rows have no admissible key and
    get uniform weights, the rest match the plain version; and causal with
    Lq < Lk. All within TOL (1e-2)."""
    q, k, v = _qkv(device, 1, 300, 200, 2 * dim, torch.bfloat16)
    got = flash_attention_packed(q, k, v, is_causal=True, head_dim=dim).float()
    torch.cuda.synchronize()
    uniform = v.float().mean(dim=1, keepdim=True).expand(1, 100, 2 * dim)
    assert _rel(got[:, :100], uniform) <= TOL
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=True, head_dim=dim)
    assert _rel(got[:, 100:], want[:, 100:]) <= TOL
    q, k, v = _qkv(device, 2, 450, 700, 2 * dim, torch.bfloat16)
    got = flash_attention_packed(q, k, v, is_causal=True, head_dim=dim)
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=True, head_dim=dim)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dim", [136, 200, 256, 384, 512])
def test_wide_kernel_matches_plain(device: torch.device, dim: int, dtype: torch.dtype) -> None:
    """128 < d <= 512, the wgmma kernel (padded to 256 or 512): ragged
    lengths, two packed heads."""
    q, k, v = _qkv(device, 1, 1000, 1100, 2 * dim, dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, head_dim=dim)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), head_dim=dim)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("dim", [256, 512])
def test_wide_kernel_causal_rows_without_keys_get_uniform_weights(device: torch.device, dim: int) -> None:
    q, k, v = _qkv(device, 1, 300, 200, dim, torch.bfloat16)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, is_causal=True, head_dim=dim).float()
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    uniform = v.float().mean(dim=1, keepdim=True).expand(1, 100, dim)
    assert _rel(got[:, :100], uniform) <= TOL
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), is_causal=True, head_dim=dim)
    assert _rel(got[:, 100:], want[:, 100:]) <= TOL


def test_wide_kernel_reads_strided_heads(device: torch.device) -> None:
    """Two 512-wide heads as column slices of one fused projection (row
    stride 3·1024), read in place by the wgmma kernel's tensor maps."""
    qkv = torch.randn((2, 300, 3 * 1024), generator=torch.Generator(device).manual_seed(3), device=device).bfloat16()
    q, k, v = qkv[..., :1024], qkv[..., 1024:2048], qkv[..., 2048:]
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, head_dim=512)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), head_dim=512)
    assert _rel(got, want) <= TOL


def test_forward_routes_by_what_the_call_carries(device: torch.device) -> None:
    """d <= 128 takes the narrow wgmma kernel, with or without a dense bias
    or an lse (modes of each kernel, which the route does not read: SD1.5's
    d = 40 training forward with its lse runs the narrow kernel); d > 128
    the wide wgmma kernel; float32 the FFMA kernel."""
    for dim in NARROW_DIMS:
        for dtype in (torch.bfloat16, torch.float16):
            assert fa.forward_kernel(dtype, dim) == "flash_fwd_narrow_kernel"
    assert fa.forward_kernel(torch.bfloat16, 136) == "flash_fwd_wgmma_kernel"
    assert fa.forward_kernel(torch.float32, 64) == "flash_fwd_f32_kernel"
    with pytest.raises(ValueError):
        fa.forward_kernel(torch.bfloat16, 12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dim", NARROW_DIMS)
def test_narrow_kernel_matches_plain(device: torch.device, dim: int, dtype: torch.dtype) -> None:
    """Ragged lengths (neither a multiple of 64), Lq != Lk, three packed
    heads: within TOL (1e-2) of the float32 plain version."""
    q, k, v = _qkv(device, 2, 1000, 1100, 3 * dim, dtype)
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, head_dim=dim)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_packed_plain(q.float(), k.float(), v.float(), head_dim=dim)
    assert _rel(got, want) <= TOL


# dense biases of the narrow kernel's lse tests, over (B, H, Lq, Lk) =
# (2, 3, 300, 260): full (8-byte column pairs), broadcast over heads, over
# batch, heads and rows (strides 0), and transposed (column stride Lq: one
# value a load)
NARROW_BIASES = {
    "none": None,
    "full": (2, 3, 300, 260),
    "over heads": (2, 1, 300, 260),
    "keys only": (1, 1, 1, 260),
    "transposed": "transposed",
}


def _bias(device: torch.device, kind: str) -> torch.Tensor | None:
    gen = torch.Generator(device).manual_seed(len(kind))
    shape = NARROW_BIASES[kind]
    if shape == "transposed":
        return torch.randn((2, 3, 260, 300), generator=gen, device=device).transpose(-1, -2)
    return None if shape is None else torch.randn(shape, generator=gen, device=device)


@pytest.mark.parametrize("bias", list(NARROW_BIASES))
@pytest.mark.parametrize("dim", NARROW_DIMS)
def test_narrow_kernel_lse_and_dense_bias_match_plain(device: torch.device, dim: int, bias: str) -> None:
    """The narrow kernel's lse output and dense-bias mode at each of its
    instances (64, 80, 128) and the widths that pad into them, causal and
    ragged with Lq = 300 > Lk = 260: the first 40 rows have no admissible
    key, get uniform weights and the lse of their -1e30 scores, as the
    plain version gives them. out within TOL, lse within LSE_TOL."""
    q, k, v = _qkv4(device, 2, 300, 260, 3, dim)
    b = _bias(device, bias)
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, b, is_causal=True, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert lse is not None and lse.shape == (2, 3, 300)
    want_out, want_lse = fa._plain_forward(q.float(), k.float(), v.float(), b, True, None)
    assert _rel(out, want_out) <= TOL
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    assert _rel(out[:, :, :40], v.float().mean(dim=2, keepdim=True).expand(2, 3, 40, dim)) <= TOL


@pytest.mark.parametrize("masked", [-1e30, torch.finfo(torch.float32).min])
@pytest.mark.parametrize("dim", [40, 64, 80, 128])
def test_narrow_kernel_fully_masked_bias_row(device: torch.device, dim: int, masked: float) -> None:
    """A boolean keep-mask as a bias (B, 1, Lq, Lk) of `masked` (-1e30, or
    float32's lowest, which times log2(e) would overflow to -inf), one row
    with no key: uniform weights on that row; out within TOL, lse within
    LSE_TOL on the other rows. The kernel counts a bias below -1e30 as
    -1e30, so that row's lse is within float32 rounding of -1e30."""
    q, k, v = _qkv4(device, 1, 256, 320, 2, dim)
    keep = torch.rand((1, 1, 256, 320), generator=torch.Generator(device).manual_seed(dim), device=device) > 0.5
    keep[..., 9, :] = False
    bias = torch.where(keep, 0.0, masked)
    out, lse = flash_attention_forward(q, k, v, bias, with_lse=True)
    want_out, want_lse = fa._plain_forward(q.float(), k.float(), v.float(), bias, False, None)
    assert lse is not None
    assert bool(out.isfinite().all())
    assert _rel(out, want_out) <= TOL
    assert _rel(out[..., 9, :], v.float().mean(dim=2)) <= TOL
    rows = torch.arange(256, device=device) != 9
    assert float((lse - want_lse)[..., rows].abs().max()) <= LSE_TOL
    assert float((lse[..., 9] / -1e30 - 1.0).abs().max()) <= 1e-6


def test_kernel_refuses_what_it_does_not_take(device: torch.device) -> None:
    q, k, v = _qkv(device, 1, 64, 64, 256, torch.float64)
    with pytest.raises(TypeError):
        flash_attention_packed(q, k, v, head_dim=64)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, head_dim=12)
    # a head of d = 256 under autograd takes the wide backward kernel, against the float32 plain version
    leaves = [x.requires_grad_() for x in (q, k, v)]
    g = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(1), device=device).bfloat16()
    got = torch.autograd.grad(flash_attention_packed(*leaves, head_dim=256), leaves, g)
    ref = [x.detach().float().requires_grad_() for x in leaves]
    want = torch.autograd.grad(flash_attention_packed_plain(*ref, head_dim=256), ref, g.float())
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_TOL


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal,bias_shape",
    [
        (1, 200, 300, 8, 40, False, None),
        (2, 1000, 1100, 5, 64, False, None),
        (2, 256, 256, 4, 64, True, None),
        (1, 1024, 1024, 4, 64, False, (1, 4, 1024, 1024)),  # a full float32 bias
        (2, 300, 260, 3, 80, False, (2, 1, 1, 260)),  # a broadcast key bias (stride 0)
        (1, 256, 256, 1, 512, True, (1, 1, 256, 256)),  # the wgmma kernel: a dense bias, causal
        (2, 1000, 1100, 2, 200, False, None),  # the wgmma kernel, padded to 256: ragged
    ],
)
def test_forward_with_bias_and_lse(
    device: torch.device,
    batch: int,
    lq: int,
    lk: int,
    heads: int,
    dim: int,
    causal: bool,
    bias_shape: tuple[int, ...] | None,
) -> None:
    q, k, v = _qkv4(device, batch, lq, lk, heads, dim)
    bias = None if bias_shape is None else torch.randn(bias_shape, device=device)
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, bias, is_causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert lse is not None and lse.shape == (batch, heads, lq) and lse.dtype == torch.float32
    want_out, want_lse = fa._plain_forward(q.float(), k.float(), v.float(), bias, causal, None)
    assert _rel(out, want_out) <= TOL
    assert float((lse - want_lse).abs().max()) <= LSE_TOL


def test_boolean_mask_with_a_fully_masked_row_gives_uniform_weights(device: torch.device) -> None:
    from refiners_tpu_torch.ops.attention import dot_product_attention

    q, k, v = _qkv4(device, 1, 256, 256, 2, 64)
    mask = torch.rand((1, 1, 256, 256), generator=torch.Generator(device).manual_seed(1), device=device) > 0.5
    mask[..., 7, :] = False
    got = dot_product_attention(q, k, v, mask=mask, use_flash=True).float()
    want = flash_attention_plain(q.float(), k.float(), v.float(), bias=torch.where(mask, 0.0, -1e30))
    assert _rel(got, want) <= TOL
    assert _rel(got[..., 7, :], v.float().mean(dim=2)) <= TOL


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal",
    [
        (2, 1000, 1100, 5, 64, False),  # ragged
        (2, 256, 256, 4, 64, True),
        (1, 300, 200, 2, 64, True),  # causal rows without keys: zero gradient
        (1, 512, 512, 8, 40, False),
        (1, 512, 512, 8, 80, True),
        (1, 200, 330, 2, 128, False),
    ],
)
def test_backward_matches_plain(
    device: torch.device, batch: int, lq: int, lk: int, heads: int, dim: int, causal: bool
) -> None:
    q, k, v = _qkv4(device, batch, lq, lk, heads, dim)
    out, lse = flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
    do = torch.randn_like(out)
    before = _launches()
    grads = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1], before[2] + 1, before[3] + 1]
    want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal)
    for got, ref in zip(grads, want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel(got, ref) <= GRAD_TOL
    if lq > lk and causal:
        assert float(grads[0][:, :, : lq - lk].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dim", [40, 48, 64, 80, 128])
def test_dkv_kernel_matches_plain(device: torch.device, dim: int, causal: bool, dtype: torch.dtype) -> None:
    """The dK/dV wgmma kernel at each of its instances (D = 64 for d = 40
    and 48, 80, 128), ragged with Lq = 330 > Lk = 200 (two blocks of 128 keys, the second
    partial; six query tiles, the last partial; each head's lse and delta
    start off a 16-byte boundary): with `causal` the first 130 query rows
    have no admissible key and get zero dq. dq, dk, dv within GRAD_TOL."""
    q, k, v = (x.to(dtype) for x in _qkv4(device, 2, 330, 200, 3, dim))
    out, lse = flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
    do = torch.randn_like(out)
    before = _launches()
    grads = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1], before[2] + 1, before[3] + 1]
    want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and _rel(got, ref) <= GRAD_TOL
    if causal:
        assert float(grads[0][:, :, :130].abs().max()) == 0.0


@pytest.mark.parametrize("dim", [40, 64, 80, 128])
def test_dkv_kernel_reads_a_fused_projection(device: torch.device, dim: int) -> None:
    """q, k, v as head views of one (B, L, 3·H·D) projection (row stride
    3·H·D, k starting H·D after q), read in place by the dK/dV kernel's
    tensor maps; dk and dv within GRAD_TOL."""
    b, seq, heads = 2, 520, 4
    gen = torch.Generator(device).manual_seed(dim + 1)
    qkv = torch.randn((b, seq, 3 * heads * dim), generator=gen, device=device).bfloat16()
    q, k, v = qkv.reshape(b, seq, 3, heads, dim).permute(2, 0, 3, 1, 4)
    assert k.stride(2) == 3 * heads * dim
    out, lse = flash_attention_forward(q, k, v, with_lse=True)
    do = torch.randn_like(out)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, False, dim**-0.5)
    _, want_dk, want_dv = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float())
    assert _rel(dk, want_dk) <= GRAD_TOL and _rel(dv, want_dv) <= GRAD_TOL


def _dq_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, lse, do, delta) of the forward kernel on q, k, v, as the backward
    entry hands them to the dQ kernel."""
    out, lse = flash_attention_forward(q, k, v, is_causal=causal, with_lse=True)
    do = torch.randn_like(out)
    return out, lse, do, (do.float() * out.float()).sum(-1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(330, 200), (200, 330)])
@pytest.mark.parametrize("dim", [40, 64, 80, 128])
def test_dq_kernel_matches_plain(
    device: torch.device, dim: int, lq: int, lk: int, causal: bool, dtype: torch.dtype
) -> None:
    """The dQ wgmma kernel at each of its instances (D = 64 for d = 40 and
    64, 80, 128) against the float32 plain version: three blocks of 128
    query rows or two, the last partial (its second warpgroup holds 10 rows
    at Lq = 330, 8 at Lq = 200), a ragged last key tile, each head's lse and
    delta off a 16-byte boundary; with `causal` and Lq > Lk the first 130
    rows have no admissible key and get dq exactly 0. One launch, dq within
    GRAD_TOL."""
    q, k, v = (x.to(dtype) for x in _qkv4(device, 2, lq, lk, 3, dim))
    out, lse, do, delta = _dq_inputs(q, k, v, causal)
    before = _launches()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, dim**-0.5)
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1], before[2], before[3] + 1]
    want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float(), causal)[0]
    assert dq.dtype == dtype and dq.shape == q.shape and bool(torch.isfinite(dq).all())
    assert _rel(dq, want) <= GRAD_TOL
    if causal and lq > lk:
        assert float(dq[:, :, : lq - lk].abs().max()) == 0.0


@pytest.mark.parametrize("dim", [40, 64, 80, 128])
def test_dq_kernel_reads_a_fused_projection(device: torch.device, dim: int) -> None:
    """q, k, v as head views of one (B, L, 3·H·D) projection (row stride
    3·H·D, k starting H·D after q), read in place by the dQ kernel's tensor
    maps; L = 520 leaves the last block 8 rows, so its second warpgroup
    holds none and still takes its turns. dq within GRAD_TOL."""
    b, seq, heads = 2, 520, 4
    gen = torch.Generator(device).manual_seed(dim + 2)
    qkv = torch.randn((b, seq, 3 * heads * dim), generator=gen, device=device).bfloat16()
    q, k, v = qkv.reshape(b, seq, 3, heads, dim).permute(2, 0, 3, 1, 4)
    assert q.stride(2) == 3 * heads * dim
    out, lse, do, delta = _dq_inputs(q, k, v, False)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False, dim**-0.5)
    want = flash_attention_backward_plain(q.float(), k.float(), v.float(), out.float(), lse, do.float())[0]
    assert _rel(dq, want) <= GRAD_TOL


def test_dq_kernel_is_deterministic(device: torch.device) -> None:
    """No atomics: two calls on the same inputs give bit-equal dq."""
    q, k, v = _qkv4(device, 2, 1000, 1100, 5, 64)
    _, lse, do, delta = _dq_inputs(q, k, v, True)
    first = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, 0.125)
    second = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(first, second)


def test_packed_backward_reads_strided_heads(device: torch.device) -> None:
    """Autograd through the packed entry, q, k, v as column slices of one
    fused projection: the backward kernels read the heads in place."""
    qkv = torch.randn((2, 640, 3 * 320), device=device).bfloat16().requires_grad_()
    q, k, v = qkv[..., :320], qkv[..., 320:640], qkv[..., 640:]
    before = _launches()
    out = flash_attention_packed(q, k, v, head_dim=40)
    do = torch.randn_like(out)
    (grad,) = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1] + 1, before[2] + 1, before[3] + 1]
    q4, k4, v4, o4, do4 = (x.detach().float().reshape(2, 640, 8, 40).transpose(1, 2) for x in (q, k, v, out, do))
    _, lse = fa._plain_forward(q4, k4, v4, None, False, None)
    want = flash_attention_backward_plain(q4, k4, v4, o4, lse, do4)
    for got, ref in zip(grad.split(320, dim=-1), want):
        assert _rel(got, ref.transpose(1, 2).reshape(2, 640, 320)) <= GRAD_TOL


def test_bias_backward_recomputes_through_the_plain_version(device: torch.device) -> None:
    q, k, v = (x.requires_grad_() for x in _qkv4(device, 1, 128, 160, 2, 64))
    bias = torch.randn((1, 2, 128, 160), device=device, requires_grad=True)
    out = flash_attention(q, k, v, bias=bias)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v, bias), do)
    want = torch.autograd.grad(flash_attention_plain(q, k, v, bias=bias), (q, k, v, bias), do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_TOL


@pytest.mark.parametrize(
    "batch,lq,lk,heads,dim,causal,bias_shape",
    [
        (1, 200, 300, 8, 40, False, None),
        (2, 256, 256, 4, 64, True, None),
        (1, 300, 200, 2, 64, True, None),  # causal rows without keys
        (2, 300, 260, 3, 80, False, (2, 1, 1, 260)),  # a broadcast key bias (stride 0)
        (1, 200, 330, 2, 128, False, (1, 2, 200, 330)),
    ],
)
def test_float32_kernels_match_plain(
    device: torch.device,
    batch: int,
    lq: int,
    lk: int,
    heads: int,
    dim: int,
    causal: bool,
    bias_shape: tuple[int, ...] | None,
) -> None:
    """The FFMA kernels: float32 forward, lse and backward against the
    float32 plain versions."""
    q, k, v = (x.float() for x in _qkv4(device, batch, lq, lk, heads, dim))
    bias = None if bias_shape is None else torch.randn(bias_shape, device=device)
    before = _launches()
    out, lse = flash_attention_forward(q, k, v, bias, is_causal=causal, with_lse=True)
    do = torch.randn_like(out)
    grads = flash_attention_backward(q, k, v, out, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1] + 1, before[2] + 1, before[3] + 1]
    want_out, want_lse = fa._plain_forward(q, k, v, bias, causal, None)
    assert out.dtype == torch.float32 and _rel(out, want_out) <= F32_TOL
    assert float((lse - want_lse).abs().max()) <= F32_LSE_TOL
    want = flash_attention_backward_plain(q, k, v, out, lse, do, causal)
    for got, ref in zip(grads, want):
        assert got.dtype == torch.float32 and _rel(got, ref) <= F32_TOL


def test_float32_on_the_card_runs_the_kernels(device: torch.device) -> None:
    """A float32 module routes its long sites to the kernels, forward and
    backward, and agrees with the same module on the plain path."""
    layer = fl.SelfAttention(embedding_dim=320, num_heads=8).to(device)
    x = torch.randn((1, 4096, 320), device=device, requires_grad=True)
    before = _launches()
    out = layer(x)
    (grad,) = torch.autograd.grad(out, x, torch.ones_like(out))
    torch.cuda.synchronize()
    assert _launches() == [before[0], before[1] + 1, before[2] + 1, before[3] + 1]
    for sdpa in layer.layers(fl.ScaledDotProductAttention, recurse=True):
        sdpa.is_optimized = False
    plain = layer(x)
    (plain_grad,) = torch.autograd.grad(plain, x, torch.ones_like(plain))
    assert _rel(out, plain) <= F32_TOL and _rel(grad, plain_grad) <= F32_TOL
    with torch.no_grad():
        sliced = fl.ScaledDotProductAttention(num_heads=8, slice_size=64)(x, x, x)
    assert _launches()[0] == before[0] + 1 and bool(torch.isfinite(sliced).all())


def _relpos_operands(
    device: torch.device, batch: int, kh: int, kw: int, heads: int, dim: int, dtype: torch.dtype
) -> list[torch.Tensor]:
    """q, k, v (B, H, kh·kw, D) and the decomposed bias v_rel (B, H, L, kh),
    h_rel (B, H, L, kw), all in `dtype`, scaled as SAM's are (|bias| ~ 1)."""
    gen = torch.Generator(device).manual_seed(kh * 31 + kw + dim)
    seq = kh * kw
    q, k, v = (torch.randn((batch, heads, seq, dim), generator=gen, device=device).to(dtype) for _ in range(3))
    v_rel = torch.randn((batch, heads, seq, kh), generator=gen, device=device).to(dtype)
    h_rel = torch.randn((batch, heads, seq, kw), generator=gen, device=device).to(dtype)
    return [q, k, v, v_rel, h_rel]


@pytest.mark.parametrize(
    "batch,kh,kw,heads,dim,dtype",
    [
        (1, 64, 64, 16, 80, torch.bfloat16),  # a SAM-H global layer
        (25, 14, 14, 16, 80, torch.bfloat16),  # a SAM-H windowed layer
        (1, 10, 10, 1, 32, torch.bfloat16),  # where the TPU kernel falls back to a dense bias
        (2, 16, 16, 2, 64, torch.float16),
        (1, 8, 24, 2, 128, torch.bfloat16),  # a key grid that is not square
        (2, 12, 20, 2, 80, torch.bfloat16),  # kw does not divide 64: the counters wrap inside a tile
        (1, 20, 12, 3, 72, torch.float16),  # and the transpose, at d = 72
        (1, 130, 130, 1, 64, torch.bfloat16),  # tables past 64 KiB: v_rel and h_rel read through L1
        (1, 256, 3, 2, 40, torch.bfloat16),  # the tallest grid, at d = 40
        (1, 16, 16, 2, 160, torch.bfloat16),  # the wgmma kernel, padded to 256
        (1, 16, 16, 2, 256, torch.bfloat16),  # the wgmma kernel
        (1, 64, 64, 16, 80, torch.float32),
        (25, 14, 14, 16, 80, torch.float32),
        (1, 12, 20, 2, 160, torch.float32),
    ],
)
def test_relpos_kernel_matches_plain(
    device: torch.device, batch: int, kh: int, kw: int, heads: int, dim: int, dtype: torch.dtype
) -> None:
    q, k, v, v_rel, h_rel = _relpos_operands(device, batch, kh, kw, heads, dim, dtype)
    if dtype != torch.float32 and dim <= 128:
        assert fa.forward_kernel(dtype, dim) == "flash_fwd_narrow_kernel"
    before = fa.flash_attention_relpos.launches
    got = fa.flash_attention_relpos(q, k, v, v_rel, h_rel)
    torch.cuda.synchronize()
    assert fa.flash_attention_relpos.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()  # heads merge for free
    want = fa.flash_attention_relpos_plain(*(x.float() for x in (q, k, v, v_rel, h_rel)))
    assert _rel(got, want) <= (F32_TOL if dtype == torch.float32 else TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_relpos_kernel_reads_a_fused_projection_in_place(device: torch.device, dtype: torch.dtype) -> None:
    """q, k, v as head views of one (B, L, 3, H, D) projection, as SAM's
    encoder gives them: row stride 3·H·D, k starting H·D after q."""
    b, kh, kw, heads, dim = 2, 14, 14, 4, 80
    seq = kh * kw
    gen = torch.Generator(device).manual_seed(5)
    qkv = torch.randn((b, seq, 3 * heads * dim), generator=gen, device=device).to(dtype)
    q, k, v = qkv.reshape(b, seq, 3, heads, dim).permute(2, 0, 3, 1, 4)
    assert q.stride(2) == 3 * heads * dim
    v_rel = torch.randn((b, heads, seq, kh), generator=gen, device=device).to(dtype)
    h_rel = torch.randn((b, heads, seq, kw), generator=gen, device=device).to(dtype)
    got = fa.flash_attention_relpos(q, k, v, v_rel, h_rel)
    want = fa.flash_attention_relpos_plain(*(x.float() for x in (q, k, v, v_rel, h_rel)))
    assert _rel(got, want) <= (F32_TOL if dtype == torch.float32 else TOL)


def test_relpos_kernel_refuses_what_it_does_not_take(device: torch.device) -> None:
    q, k, v, v_rel, h_rel = _relpos_operands(device, 1, 8, 8, 2, 64, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="inference only"):
        fa.flash_attention_relpos(q.requires_grad_(), k, v, v_rel, h_rel)
    q = q.detach()
    with pytest.raises(ValueError, match="kv length"):
        fa.flash_attention_relpos(q, k, v, v_rel[..., :7], h_rel)
    with pytest.raises(TypeError):
        fa.flash_attention_relpos(q, k, v, v_rel.float(), h_rel)
    # a key grid of 257 x 1 is beyond the cap of 256 per side
    q, k, v, v_rel, h_rel = _relpos_operands(device, 1, 257, 1, 1, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="kh, kw <="):
        fa.flash_attention_relpos(q, k, v, v_rel, h_rel)
