"""Int8 quantization per row: the hand-written Hopper kernel K6 with its
round-to-nearest row mode, and the quantized layers; counterpart of
``refiners_tpu/ops/quant.py``.

One kernel (``csrc/quant.cu``) computes a per-row abs-max scale
``max(amax, 1e-8) / 127`` and int8 values clipped to ±127, in two modes:

- ``quantize_int8`` replaces the TPU kernel ``_quantize_kernel``: per output
  channel, stochastic rounding ``floor(w/scale + u)`` with 24 random bits.
  The port's weight is (out, in), so an output channel is a row here where
  it is a column in the JAX package. Its two branches follow the JAX
  function's: on a CUDA tensor, the kernel with Philox4x32-10 bits (key
  (seed & 0xffffffff, seed >> 32), counter (i >> 2 as two 32-bit words, 0,
  0) for the flat row-major index i, word i & 3), counted by
  ``quantize_int8.launches``, and ``quantize_int8_plain`` computes the same
  stream in torch, bit for bit; on any other tensor, the JAX function's
  deterministic off-TPU branch, round to nearest, so the CPU agrees with JAX
  exactly.
- ``quantize_rows_int8`` rounds to nearest (half to even), per row of an
  (M, K) activation: the per-token quantization of the JAX package's W8A8
  ``int8_matmul`` (in XLA there), counted by ``quantize_rows_int8.launches``
  and bit-equal to ``quantize_rows_int8_plain``, which is also the
  deterministic branch above.

``int8_matmul`` is the product, which the JAX package leaves to XLA outside
any Pallas kernel: W8A8 (per-token activation quantization through the row
mode on the card, then ``torch._int_mm``, int8 × int8 → int32) or W8A16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.ops.build import DTYPE_CODES, load_library, stream
# Philox4x32-10 constants (Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
# torch._int_mm on the card takes more than 16 rows: fewer are padded with zeros to this
_INT_MM_MIN_ROWS = 32


# ---------------------------------------------------------------------------
# Philox4x32-10 in torch (int64 tensors holding 32-bit words)
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the constant `a` times the 32-bit words
    `b`. The 64-bit product overflows int64, so it is formed from 16-bit
    limbs, whose partial products fit."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh  # < 2^33
    low = al * bl + ((mid & 0xFFFF) << 16)  # < 2^33
    high = ah * bh + (mid >> 16) + (low >> 32)
    return high & _MASK32, low & _MASK32


def philox4x32_10(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of (N, 4) int64 counters holding 32-bit words, with key
    (seed & 0xffffffff, seed >> 32): (N, 4) int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for round_ in range(10):
        if round_:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), dim=-1)


def _random_bits(shape: tuple[int, int], seed: int, device: torch.device) -> torch.Tensor:
    """The kernel's 32-bit word for every element of a row-major `shape`:
    word i & 3 of the Philox block of counter (i >> 2, 0, 0)."""
    numel = shape[0] * shape[1]
    quads = torch.arange((numel + 3) // 4, device=device, dtype=torch.int64)
    zeros = torch.zeros_like(quads)
    counter = torch.stack((quads & _MASK32, quads >> 32, zeros, zeros), dim=-1)
    return philox4x32_10(counter, seed).reshape(-1)[:numel].reshape(shape)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _scale(abs_max: torch.Tensor) -> torch.Tensor:
    """max(abs_max, 1e-8) / 127 as an IEEE float32 division. The divisor is
    a tensor: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which differs from the kernel's division in the last bit."""
    return torch.clamp_min(abs_max, 1e-8) / torch.full_like(abs_max, 127.0)


def quantize_rows_int8_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the row mode, and the JAX function's off-TPU branch:
    per-row scale, round to nearest (half to even). (M, K) → (int8 values
    (M, K), float32 scales (M, 1))."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=1, keepdim=True))
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def quantize_int8_plain(w: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: stochastic rounding with the kernel's
    Philox bits. (out, in) weight → (int8 values (out, in), float32 scales (1, out))."""
    w32 = w.float()
    scale = _scale(w32.abs().amax(dim=1))
    u = (_random_bits(tuple(w.shape), seed, w.device) & 0xFFFFFF).float() * 2.0**-24
    values = torch.clamp(torch.floor(w32 / scale[:, None] + u), -127, 127).to(torch.int8)
    return values, scale[None, :]


def _launch(x: torch.Tensor, out_rows: int, stochastic: bool, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on (M, K) `x`: int8 values (out_rows, K), rows past M
    zero, and float32 scales (M,)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"the quantization kernel takes bfloat16, float16 or float32, got {x.dtype}")
    if x.ndim != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"the quantization kernel takes rows of unit stride, got shape {tuple(x.shape)}, strides {x.stride()}")
    rows, cols = x.shape
    if rows == 0 or cols == 0 or max(rows, out_rows) > 2**31 - 1:
        raise ValueError(f"cannot quantize a tensor of shape {tuple(x.shape)}")
    values = torch.empty((max(rows, out_rows), cols), device=x.device, dtype=torch.int8)
    scales = torch.empty((rows,), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = load_library().refiners_quantize_int8(
            x.data_ptr(), values.data_ptr(), scales.data_ptr(), DTYPE_CODES[x.dtype], rows, values.shape[0], cols,
            x.stride(0), int(stochastic), seed & 0xFFFFFFFFFFFFFFFF, stream(x),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"int8 quantization kernel launch failed: cudaError {err}")
    return values, scales


def quantize_int8(w: torch.Tensor, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight → (int8 values (out, in), float32 scales (1, out)).

    On a CUDA tensor this launches the kernel (stochastic rounding,
    ``quantize_int8.launches``); on any other it rounds deterministically, as
    the JAX function does off the TPU."""
    if w.ndim != 2:
        raise ValueError(f"expected an (out, in) weight, got {tuple(w.shape)}")
    if not w.is_cuda:
        values, scales = quantize_rows_int8_plain(w)
        return values, scales.reshape(1, -1)
    values, scales = _launch(w, 0, stochastic=True, seed=seed)
    quantize_int8.launches += 1  # type: ignore[attr-defined]
    return values, scales[None, :]


def quantize_rows_int8(x: torch.Tensor, min_rows: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) → (int8 values (max(M, min_rows), K), float32 scales (M, 1)):
    the row mode, round to nearest. Rows past M are zero (the padding of
    ``torch._int_mm``).

    On a CUDA tensor this launches the kernel (``quantize_rows_int8.launches``);
    on any other it takes ``quantize_rows_int8_plain``."""
    if x.ndim != 2:
        raise ValueError(f"expected (rows, features), got {tuple(x.shape)}")
    if not x.is_cuda:
        values, scales = quantize_rows_int8_plain(x)
        if values.shape[0] < min_rows:
            values = F.pad(values, (0, 0, 0, min_rows - values.shape[0]))
        return values, scales
    values, scales = _launch(x, min_rows, stochastic=False, seed=0)
    quantize_rows_int8.launches += 1  # type: ignore[attr-defined]
    return values, scales[:, None]


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------


def _matmul_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 (M, K) times w (N, K)ᵀ with a float32 result: in x's dtype with
    float32 output where torch offers it (``mm`` with ``out_dtype`` on the
    card), else in float32."""
    if x2.is_cuda and x2.dtype != torch.float32 and "dtype" in torch.ops.aten.mm.overloads():
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return torch.mm(x2.float(), w.float().t())


def int8_matmul(x: torch.Tensor, values: torch.Tensor, scales: torch.Tensor, act_quant: bool = True) -> torch.Tensor:
    """x (…, in) times dequant(values)ᵀ, values (out, in) int8, scales (1, out)
    float32; the result in x's dtype.

    W8A8 (`act_quant`): x is quantized per token (row abs-max → int8;
    ``quantize_rows_int8``, the kernel on the card), the product is int8 ×
    int8 → int32 (``torch._int_mm``), then the two scales are applied in
    float32. W8A16: values cast to x's dtype, the product in float32, then
    the scales."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if not act_quant:
        y = _matmul_f32(x2, values.to(x.dtype)) * scales.float()
        return y.to(x.dtype).reshape(*x.shape[:-1], -1)
    n = values.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"the int8 product takes in and out features in multiples of 8, got {k} and {n}")
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    xq, x_scale = quantize_rows_int8(x2, min_rows=_INT_MM_MIN_ROWS)
    m = x2.shape[0]
    y = torch._int_mm(xq, values.t())[:m]
    return (y.float() * x_scale * scales.float()).to(x.dtype).reshape(*x.shape[:-1], n)


class QuantizedLinear(fl.WeightedModule):
    """Drop-in int8 replacement for `fl.Linear`: keys ``weight`` (int8,
    (out, in)), ``scales`` ((1, out) float32) and ``bias`` (the linear's,
    shared), as in the JAX package. Never requires grad.

    ``scales`` is a buffer, not a parameter, so a chain's dtype (its first
    floating parameter, which `fl.Converter` casts to) stays the model's:
    in the JAX package the float32 scales come first and turn a quantized
    bf16 UNet's time embedding, and from there its whole residual stream,
    to float32."""

    def __init__(self, linear: fl.Linear, seed: int = 0, act_quant: bool = True) -> None:
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.act_quant = act_quant
        values, scales = quantize_int8(linear.weight.detach(), seed=seed)
        self.weight = torch.nn.Parameter(values, requires_grad=False)
        self.register_buffer("scales", scales)
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight, self.scales, act_quant=self.act_quant)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def quantize_linears(module: fl.Chain, min_features: int = 256, act_quant: bool = True) -> int:
    """Replace every `fl.Linear` (not its subclasses) with both feature
    counts at least `min_features` by a `QuantizedLinear`, in place; the
    n-th one replaced gets seed n. Returns the number replaced.
    `act_quant` selects W8A8 (default) or W8A16."""
    count = 0
    for linear, parent in list(module.walk(fl.Linear, recurse=True)):
        if type(linear) is not fl.Linear:
            continue  # keep subclasses intact
        if linear.in_features < min_features or linear.out_features < min_features:
            continue
        parent.replace(linear, QuantizedLinear(linear, seed=count, act_quant=act_quant))
        count += 1
    return count


quantize_int8.launches = 0  # type: ignore[attr-defined]
quantize_rows_int8.launches = 0  # type: ignore[attr-defined]
