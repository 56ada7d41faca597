"""Fused GroupNorm(+SiLU) over NCHW tensors: two hand-written Hopper kernels.

Replaces the TPU kernels of ``refiners_tpu/ops/group_norm.py``, which the
opt-in pass ``fuse_group_norm_silu`` (``fluxion/optimization.py``) puts in
every GroupNorm → SiLU pair of the UNet and the VAE:

- ``_stats_kernel`` (K5a) becomes ``group_norm_stats``: in contiguous NCHW,
  group g of sample b is one contiguous run of (C/G)·H·W elements (a
  "slab"). The slab is cut into chunks of ``chunk_len(dtype)`` elements,
  one block each, and every block writes the float32 sums Σ(x − p) and
  Σ(x − p)² of its chunk, shifted by the slab's first element p (the pivot),
  to a (B·G, chunks, 2) scratch tensor. The JAX kernel's single-pass
  E[x²] − E[x]² cancels when the mean is large against the spread; the
  pivot keeps the shifted mean of the order of the spread.
- ``_apply_kernel`` (K5b) becomes ``group_norm_apply``: each block merges
  its slab's partials into the mean and the variance, folds them with the
  affine into per-channel float32 scale and shift (the fold the JAX package
  runs in XLA between its two kernels), then writes
  y = x·scale + shift, SiLU optional, in x's dtype.

A fused GroupNorm+SiLU is exactly these two launches: ``group_norm_silu``.
Its gradient recomputes through autograd of the plain version, as the JAX
package's ``custom_vjp`` does (there is no backward kernel).

Layout: the JAX function takes channels-last (B, …, C); the port is NCHW
throughout and groups dim 1, so its tests transpose at the boundary.

Each kernel has its plain PyTorch version beside it (``*_plain``), which a
wrapper runs for a tensor that is not on the card; on a CUDA tensor it
launches its kernel or raises. Launch counters: ``group_norm_stats.launches``
and ``group_norm_apply.launches``. The kernels take bfloat16, float16 and
float32 and compute in float32; ``group_norm_silu_plain`` is the counterpart
of the JAX ``_xla_reference`` (two-pass float32 statistics).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from refiners_tpu_torch.ops.build import DTYPE_CODES, load_library, stream

# each block: 256 threads, 8 vectors of 16 bytes per thread (csrc/group_norm.cu)
_THREADS = 256
_VECTORS_PER_THREAD = 8
# the apply kernel keeps a slab's per-channel scale and shift in shared memory
MAX_CHANNELS_PER_GROUP = 4096


def chunk_len(dtype: torch.dtype) -> int:
    """Elements of a slab per block of either kernel: 16384 in 16-bit types, 8192 in float32."""
    return _THREADS * _VECTORS_PER_THREAD * (16 // dtype.itemsize)


def _slabs(x: torch.Tensor, num_groups: int) -> tuple[int, int]:
    """(number of slabs B·G, elements per slab)."""
    b = x.shape[0]
    return b * num_groups, x.numel() // (b * num_groups)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def group_norm_silu_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over channel dim 1 of (B, C, …): float32, two-pass
    statistics, cast back to x's dtype (JAX: ``_xla_reference``)."""
    b = x.shape[0]
    xg = x.reshape(b, num_groups, -1).float()
    var, mean = torch.var_mean(xg, dim=-1, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    affine = (-1,) + (1,) * (x.ndim - 2)
    y = y * weight.float().reshape(affine) + bias.float().reshape(affine)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_stats_plain(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of `group_norm_stats`: (B·G, chunks, 2) float32, the
    sums of (x − pivot) and (x − pivot)² over each chunk of each slab."""
    slabs, n = _slabs(x, num_groups)
    chunk = chunk_len(x.dtype)
    chunks = -(-n // chunk)
    xs = x.reshape(slabs, n).float()
    d = F.pad(xs - xs[:, :1], (0, chunks * chunk - n)).reshape(slabs, chunks, chunk)
    return torch.stack((d.sum(dim=-1), (d * d).sum(dim=-1)), dim=-1)


def group_norm_apply_plain(
    x: torch.Tensor,
    partials: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """Plain version of `group_norm_apply`: merge the partials, fold the
    affine into per-channel float32 scale and shift, y = x·scale + shift
    (SiLU optional) in x's dtype."""
    b, c = x.shape[:2]
    slabs, n = _slabs(x, num_groups)
    pivot = x.reshape(slabs, n)[:, 0].float()
    s1, s2 = partials.sum(dim=1).unbind(-1)
    m1 = s1 / n
    mean = (pivot + m1).reshape(b, num_groups, 1)
    rstd = (1.0 / torch.sqrt((s2 / n - m1 * m1).clamp_min(0.0) + eps)).reshape(b, num_groups, 1)
    scale = weight.float().reshape(1, num_groups, -1) * rstd
    shift = bias.float().reshape(1, num_groups, -1) - mean * scale
    affine = (b, c) + (1,) * (x.ndim - 2)
    y = x.float() * scale.reshape(affine) + shift.reshape(affine)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_input(x: torch.Tensor, num_groups: int) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"the GroupNorm kernels take bfloat16, float16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"the GroupNorm kernels take a contiguous NCHW tensor, strides {x.stride()}")
    if x.ndim < 2 or x.numel() == 0 or x.shape[1] % num_groups:
        raise ValueError(f"expected a non-empty (B, C, …) tensor with C divisible by {num_groups}, got {tuple(x.shape)}")
    if x.shape[1] // num_groups > MAX_CHANNELS_PER_GROUP:
        raise ValueError(f"at most {MAX_CHANNELS_PER_GROUP} channels per group, got {x.shape[1] // num_groups}")
    if x.shape[0] * num_groups > 65535:
        raise ValueError(f"batch·groups={x.shape[0] * num_groups} exceeds the grid's limit of 65535")


def group_norm_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K5a: the (B·G, chunks, 2) float32 partials of `group_norm_stats_plain`.

    On a CUDA tensor this launches the kernel (``group_norm_stats.launches``);
    on any other it runs the plain version."""
    if not x.is_cuda:
        return group_norm_stats_plain(x, num_groups)
    _check_input(x, num_groups)
    slabs, n = _slabs(x, num_groups)
    chunk = chunk_len(x.dtype)
    chunks = -(-n // chunk)
    partials = torch.empty((slabs, chunks, 2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = load_library().refiners_group_norm_stats(
            x.data_ptr(), partials.data_ptr(), DTYPE_CODES[x.dtype], slabs, n, chunk, chunks, stream(x)
        )
    if err != 0:
        raise RuntimeError(f"GroupNorm statistics kernel launch failed: cudaError {err}")
    group_norm_stats.launches += 1  # type: ignore[attr-defined]
    return partials


def group_norm_apply(
    x: torch.Tensor,
    partials: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """K5b: y of `group_norm_apply_plain` from K5a's partials.

    On a CUDA tensor this launches the kernel (``group_norm_apply.launches``);
    on any other it runs the plain version."""
    if not x.is_cuda:
        return group_norm_apply_plain(x, partials, weight, bias, num_groups, eps, apply_silu)
    _check_input(x, num_groups)
    slabs, n = _slabs(x, num_groups)
    chunk = chunk_len(x.dtype)
    chunks = -(-n // chunk)
    c = x.shape[1]
    if partials.shape != (slabs, chunks, 2) or partials.dtype != torch.float32 or not partials.is_contiguous():
        raise ValueError(f"partials must be contiguous float32 {(slabs, chunks, 2)}, got {tuple(partials.shape)}")
    for name, t in (("weight", weight), ("bias", bias), ("partials", partials)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    if weight.shape != (c,) or bias.shape != (c,) or not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"weight and bias must be contiguous ({c},), got {tuple(weight.shape)}, {tuple(bias.shape)}")
    if weight.dtype not in DTYPE_CODES or bias.dtype != weight.dtype:
        raise TypeError(f"weight and bias must share a bfloat16, float16 or float32 dtype, got {weight.dtype}, {bias.dtype}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().refiners_group_norm_apply(
            x.data_ptr(), y.data_ptr(), partials.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[weight.dtype], slabs, num_groups, n, n // (c // num_groups),
            c // num_groups, chunk, chunks, eps, int(apply_silu), stream(x),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"GroupNorm apply kernel launch failed: cudaError {err}")
    group_norm_apply.launches += 1  # type: ignore[attr-defined]
    return y


def _forward(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float, apply_silu: bool
) -> torch.Tensor:
    if not x.is_cuda:
        return group_norm_silu_plain(x, weight, bias, num_groups, eps, apply_silu)
    partials = group_norm_stats(x, num_groups)
    return group_norm_apply(x, partials, weight, bias, num_groups, eps, apply_silu)


class _GroupNormSiLU(torch.autograd.Function):
    """The kernels forward; the backward recomputes through autograd of the
    plain version (JAX: ``_bwd``)."""

    @staticmethod
    def forward(
        ctx: Any,
        x: torch.Tensor,
        weight: torch.Tensor,
        bias: torch.Tensor,
        num_groups: int,
        eps: float,
        apply_silu: bool,
    ) -> torch.Tensor:
        ctx.save_for_backward(x, weight, bias)
        ctx.config = (num_groups, eps, apply_silu)
        return _forward(x, weight, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = group_norm_silu_plain(*inputs, *ctx.config)
            grads = torch.autograd.grad(y, inputs, grad)
        return (*grads, None, None, None)


def group_norm_silu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = True,
) -> torch.Tensor:
    """Fused GroupNorm over channel dim 1 of (B, C, …), then SiLU unless
    `apply_silu` is False; differentiable in x, weight and bias.

    On CUDA tensors this launches K5a then K5b; on any other device it runs
    `group_norm_silu_plain`."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _GroupNormSiLU.apply(x, weight, bias, num_groups, eps, apply_silu)
    return _forward(x, weight, bias, num_groups, eps, apply_silu)


group_norm_stats.launches = 0  # type: ignore[attr-defined]
group_norm_apply.launches = 0  # type: ignore[attr-defined]
