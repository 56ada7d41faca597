"""The opt-in serving passes' kernels against their plain versions, on the card:
the fused GroupNorm(+SiLU) (K5a statistics, K5b apply) and the int8
quantization (K6 and its round-to-nearest row mode), and the int8 layers on
CUDA tensors.

These tests need an NVIDIA card with nvcc (sm_90a) and skip elsewhere. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_passes_kernel.py -q
"""

from __future__ import annotations

import pytest
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.optimization import FusedGroupNormSiLU, fuse_group_norm_silu, quantize_linears
from refiners_tpu_torch.ops import group_norm as gn
from refiners_tpu_torch.ops import quant
from refiners_tpu_torch.ops.quant import QuantizedLinear, int8_matmul

pytestmark = pytest.mark.cuda

# the kernels against their plain versions in float32 on the same inputs:
# one rounding of the output in bf16 / f16 (unit roundoff 3.9e-3), summation
# order only in float32
TOLS = {torch.bfloat16: 1e-2, torch.float16: 1e-2, torch.float32: 1e-5}
# partial sums of a chunk: float32 in both, summed in another order
STATS_RTOL = 1e-5


@pytest.fixture
def device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float()) / torch.linalg.vector_norm(want.float()))


def _gn_operands(device: torch.device, shape: tuple[int, ...], dtype: torch.dtype) -> list[torch.Tensor]:
    gen = torch.Generator(device).manual_seed(sum(shape))
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=device) * 2.0 + 0.5).to(dtype)
    w = torch.randn((c,), generator=gen, device=device) * 0.2 + 1.0
    b = torch.randn((c,), generator=gen, device=device) * 0.1
    return [x, w.to(dtype), b.to(dtype)]


@pytest.mark.parametrize(
    "shape,groups",
    [
        ((2, 96, 5, 6), 32),  # 90-element groups: unaligned chunk starts, ragged tails
        ((2, 320, 16, 16), 32),
        ((1, 64, 7, 9), 8),
        ((1, 8, 300, 300), 2),  # several chunks per slab
        ((2, 1280, 8, 8), 32),
    ],
)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_group_norm_kernels_match_plain(
    device: torch.device, shape: tuple[int, ...], groups: int, dtype: torch.dtype
) -> None:
    x, w, b = _gn_operands(device, shape, dtype)
    before = (gn.group_norm_stats.launches, gn.group_norm_apply.launches)  # type: ignore[attr-defined]
    partials = gn.group_norm_stats(x, groups)
    y = gn.group_norm_apply(x, partials, w, b, groups)
    torch.cuda.synchronize()
    assert (gn.group_norm_stats.launches, gn.group_norm_apply.launches) == (before[0] + 1, before[1] + 1)  # type: ignore[attr-defined]
    want_partials = gn.group_norm_stats_plain(x, groups)
    torch.testing.assert_close(partials, want_partials, rtol=STATS_RTOL, atol=STATS_RTOL * float(want_partials.abs().max()))
    assert y.dtype == dtype and y.shape == x.shape
    want = gn.group_norm_silu_plain(x.float(), w.float(), b.float(), groups)
    assert _rel(y, want) <= TOLS[dtype]
    assert _rel(y, gn.group_norm_apply_plain(x.float(), partials, w.float(), b.float(), groups)) <= TOLS[dtype]
    # without SiLU, through the public entry
    y_lin = gn.group_norm_silu(x, w, b, groups, eps=1e-6, apply_silu=False)
    assert _rel(y_lin, gn.group_norm_silu_plain(x.float(), w.float(), b.float(), groups, 1e-6, False)) <= TOLS[dtype]


def test_group_norm_kernels_take_unaligned_inputs_and_float32_weights(device: torch.device) -> None:
    """A tensor that starts 2 bytes past a 16-byte boundary, with float32
    weight and bias beside bf16 activations."""
    x, w, b = _gn_operands(device, (2, 96, 5, 6), torch.bfloat16)
    buffer = torch.empty(x.numel() + 1, device=device, dtype=torch.bfloat16)
    shifted = buffer[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 2
    got = gn.group_norm_silu(shifted, w.float(), b.float(), 32)
    assert _rel(got, gn.group_norm_silu_plain(x.float(), w.float(), b.float(), 32)) <= TOLS[torch.bfloat16]


def test_group_norm_kernels_raise_on_what_they_do_not_take(device: torch.device) -> None:
    x, w, b = _gn_operands(device, (1, 64, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_silu(x.transpose(2, 3), w, b, 8)
    with pytest.raises(TypeError):
        gn.group_norm_silu(x.double(), w, b, 8)
    with pytest.raises(ValueError, match="must be on"):
        gn.group_norm_apply(x, gn.group_norm_stats(x, 8), w.cpu(), b.cpu(), 8)


def test_group_norm_gradients_on_the_card(device: torch.device) -> None:
    """The forward launches the kernels; the backward recomputes through
    autograd of the plain version."""
    x, w, b = (t.requires_grad_() for t in _gn_operands(device, (2, 64, 8, 8), torch.float32))
    before = gn.group_norm_apply.launches  # type: ignore[attr-defined]
    torch.sin(gn.group_norm_silu(x, w, b, 8)).sum().backward()
    assert gn.group_norm_apply.launches == before + 1  # type: ignore[attr-defined]
    x2, w2, b2 = (t.detach().clone().requires_grad_() for t in (x, w, b))
    torch.sin(gn.group_norm_silu_plain(x2, w2, b2, 8)).sum().backward()
    for got, want in ((x.grad, x2.grad), (w.grad, w2.grad), (b.grad, b2.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_fused_layer_launches_both_kernels(device: torch.device) -> None:
    chain = fl.Chain(fl.GroupNorm(64, 8, device=device), fl.SiLU(), fl.Conv2d(64, 64, 3, padding=1, device=device))
    x = torch.randn((1, 64, 12, 12), device=device)
    with torch.no_grad():
        want = chain(x)
        assert fuse_group_norm_silu(chain) == 1
        assert isinstance(chain[0], FusedGroupNormSiLU)
        before = (gn.group_norm_stats.launches, gn.group_norm_apply.launches)  # type: ignore[attr-defined]
        got = chain(x)
    assert (gn.group_norm_stats.launches, gn.group_norm_apply.launches) == (before[0] + 1, before[1] + 1)  # type: ignore[attr-defined]
    assert _rel(got, want) <= 1e-5


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `x` that starts one element past a 16-byte boundary."""
    buffer = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    shifted = buffer[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == x.element_size()
    return shifted


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("shape", [(520, 300), (1280, 1280), (640, 2048), (64, 5120), (37, 301)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_kernel_is_bit_equal_to_plain(
    device: torch.device, shape: tuple[int, int], dtype: torch.dtype, unaligned: bool
) -> None:
    """Rows of 301 and 300 columns do not all start on a Philox block; an
    unaligned start shifts every 16-byte vector off its blocks."""
    gen = torch.Generator(device).manual_seed(shape[0] + shape[1])
    w = (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)
    w[0] *= 30.0
    w[1] = 0.0
    if unaligned:
        w = _unaligned(w)
    before = quant.quantize_int8.launches  # type: ignore[attr-defined]
    values, scales = quant.quantize_int8(w, seed=2**32 + 5)
    torch.cuda.synchronize()
    assert quant.quantize_int8.launches == before + 1  # type: ignore[attr-defined]
    want_values, want_scales = quant.quantize_int8_plain(w, seed=2**32 + 5)
    assert torch.equal(scales, want_scales)
    assert torch.equal(values, want_values)
    scaled = w.float() / scales[0][:, None]
    q = values.float()
    assert int(values.abs().max()) <= 127
    assert bool(((q == torch.floor(scaled)) | (q == torch.ceil(scaled))).all())


def test_quantize_kernel_is_unbiased(device: torch.device) -> None:
    w = torch.randn((256, 1024), generator=torch.Generator(device).manual_seed(0), device=device) * 0.02
    total = torch.zeros_like(w, dtype=torch.float64)
    for seed in range(64):
        values, scales = quant.quantize_int8(w, seed=seed)
        total += values.double()
    error = total / 64 - (w / scales[0][:, None]).double()
    assert float(error.abs().max()) <= 0.375  # 6σ of a mean of 64 Bernoulli draws
    assert abs(float(error.mean())) <= 1e-3


def _activations(device: torch.device, shape: tuple[int, int], dtype: torch.dtype) -> torch.Tensor:
    """Seeded activations with an outlier row, a zero row (from the third row
    on) and a last row of 127 and half-integers (scale exactly 1: round half
    to even decides)."""
    gen = torch.Generator(device).manual_seed(shape[0] * shape[1])
    x = torch.randn(shape, generator=gen, device=device) * 3.0
    x[0] *= 40.0
    if shape[0] > 2:
        x[1] = 0.0
    x[-1] = torch.arange(shape[1], device=device) % 9 - 4.5
    x[-1, 0] = 127.0
    return x.to(dtype)


def _check_rows(x: torch.Tensor, min_rows: int = 0) -> None:
    before = quant.quantize_rows_int8.launches  # type: ignore[attr-defined]
    values, scales = quant.quantize_rows_int8(x, min_rows=min_rows)
    torch.cuda.synchronize()
    assert quant.quantize_rows_int8.launches == before + 1  # type: ignore[attr-defined]
    rows = x.shape[0]
    assert values.dtype == torch.int8 and tuple(values.shape) == (max(rows, min_rows), x.shape[1])
    assert scales.dtype == torch.float32 and tuple(scales.shape) == (rows, 1)
    want_values, want_scales = quant.quantize_rows_int8_plain(x)
    assert torch.equal(scales, want_scales)
    assert torch.equal(values[:rows], want_values)
    assert not values[rows:].any()
    assert int(values.abs().max()) <= 127
    if rows > 2:
        zero_scale = torch.tensor(1e-8, device=x.device) / torch.tensor(127.0, device=x.device)
        assert float(scales[1]) == float(zero_scale) and not values[1].any()
    assert float(scales[-1]) == 1.0 and int(values[rows - 1, 1]) == -4 and int(values[rows - 1, 2]) == -2


@pytest.mark.parametrize("shape", [(2, 1280), (154, 2048), (2048, 1280), (8192, 640), (37, 301)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_rows_kernel_is_bit_equal_to_plain(device: torch.device, shape: tuple[int, int], dtype: torch.dtype) -> None:
    _check_rows(_activations(device, shape, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantize_rows_kernel_reads_unaligned_rows_and_pads(device: torch.device, dtype: torch.dtype) -> None:
    """A row-offset view (data_ptr one element past a 16-byte boundary, row
    stride 1281: every row starts elsewhere), an unaligned contiguous tensor,
    and zero rows written up to `min_rows`."""
    x = _activations(device, (300, 1280), dtype)
    wide = torch.zeros((300, 1281), device=device, dtype=dtype)
    wide[:, 1:] = x
    view = wide[:, 1:]
    assert view.data_ptr() % 16 == x.element_size() and view.stride() == (1281, 1)
    _check_rows(view)
    _check_rows(_unaligned(_activations(device, (37, 301), dtype)))
    _check_rows(_activations(device, (5, 2816), dtype), min_rows=32)
    with pytest.raises(ValueError, match="unit stride"):
        quant.quantize_rows_int8(x.t())


@pytest.mark.parametrize("rows", [1, 2, 16, 40])
@pytest.mark.parametrize("act_quant", [True, False])
def test_int8_matmul_on_the_card_matches_the_cpu(device: torch.device, rows: int, act_quant: bool) -> None:
    """The same values and scales on the card and on the CPU: the activations'
    quantization (the row mode, one launch) is bit-equal and the int32
    product exact, so W8A8 agrees to float32 rounding; rows ≤ 16 are padded
    for torch._int_mm on the card."""
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 320), generator=gen)
    values, scales = quant.quantize_int8(torch.randn((264, 320), generator=gen) * 0.02)
    want = int8_matmul(x, values, scales, act_quant)
    before = quant.quantize_rows_int8.launches  # type: ignore[attr-defined]
    got = int8_matmul(x.to(device), values.to(device), scales.to(device), act_quant)
    assert quant.quantize_rows_int8.launches == before + int(act_quant)  # type: ignore[attr-defined]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("act_quant", [True, False])
def test_quantized_linear_on_the_card(device: torch.device, act_quant: bool) -> None:
    """bf16 activations through QuantizedLinear (K6 at construction) against
    the float32 linear: W8A8 within 2 %, W8A16 within 1 %."""
    linear = fl.Linear(1280, 1280, device=device, dtype=torch.bfloat16)
    model = fl.Chain(linear)
    before = quant.quantize_int8.launches  # type: ignore[attr-defined]
    assert quantize_linears(model, act_quant=act_quant) == 1
    assert quant.quantize_int8.launches == before + 1  # type: ignore[attr-defined]
    layer = model[0]
    assert isinstance(layer, QuantizedLinear) and layer.weight.dtype == torch.int8
    x = torch.randn((2, 77, 1280), device=device, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(x)
        want = torch.nn.functional.linear(x.float(), linear.weight.float(), linear.bias.float())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 77, 1280)
    assert _rel(got, want) <= (0.02 if act_quant else 0.01)
