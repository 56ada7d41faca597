"""Flash attention, forward and backward: hand-written Hopper kernels.

Replaces the TPU kernels of ``refiners_tpu/ops/flash_attention.py``:

- ``_flash_kernel_packed`` (entry ``flash_attention_packed``) and
  ``_flash_kernel`` (entry ``flash_attention``), the forward over packed
  (B, L, H·D) and flat (B, H, L, D) operands, with an optional additive bias
  and an optional logsumexp residual: one CUDA kernel source,
  ``csrc/flash_attention_forward.cu``, that reads heads through strides;
- ``_flash_relpos_kernel`` (entry ``flash_attention_relpos``), the forward
  with SAM's decomposed relative-position bias, never materialized: a bias
  mode of the same source;
- ``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel`` (via
  ``_flash_backward``), the FlashAttention-2 backward:
  ``csrc/flash_attention_backward.cu``.

The TPU's lane-width head grouping (``_packed_n_sub`` and its flat fallback)
does not exist here: both entries view their operands as (B, H, L, D) through
strides and launch the same kernels, with no split/merge-heads copies. Each
source holds tensor-core versions for bfloat16 and float16 and an FFMA
version for float32 (which keeps float32 accuracy). The forward source picks
one of three kernels by dtype and head dim (`forward_kernel` names it):
float32 on FFMA; d > 128 on the wide wgmma kernel; d ≤ 128 on the narrow
wgmma kernel (TMA, two consumer warpgroups), with or without a dense or
relative-position bias and an lse output. The backward takes every head
width the forward takes: at d ≤ 128 a dK/dV and a dQ kernel, each wgmma on
TMA (two warpgroups of 64 rows, P and dS kept in registers); at
128 < d ≤ 512 one wide wgmma kernel on TMA for both entries, each block 64
rows of one gradient split along d between its two warpgroups
(`backward_kernels` names them).

Entries and their launch counters (a plain integer on each wrapper, one per
launch of its kernel):

- ``flash_attention_packed`` (inference over packed operands):
  ``flash_attention_packed.launches``;
- ``flash_attention_forward`` (the forward over 4-D views, with bias and
  logsumexp; the forward of ``flash_attention`` and the forward of both
  entries under autograd): ``flash_attention.launches``;
- ``flash_attention_relpos`` (inference only): ``flash_attention_relpos.launches``;
- ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``, both called by
  ``flash_attention_backward``: their own ``.launches``.

Each has its plain PyTorch version beside it (``*_plain``), which the CPU
takes and the card's tests compare against. On CUDA tensors a wrapper
launches its kernel or raises; on CPU tensors it runs the plain version,
and gradients flow through autograd of that version.
"""

from __future__ import annotations

import math

import torch

from refiners_tpu_torch.ops.attention import _attention, merge_heads, split_heads
from refiners_tpu_torch.ops.build import DTYPE_CODES, c_longlongs, load_library, stream

# score of a masked (query, key) pair, as in the JAX kernels; not -inf, so a
# row with no admissible key gets uniform weights
MASKED_SCORE = -1e30
# widest key grid side (kh and kw each) of the relative-position kernel
MAX_RELPOS_SIDE = 256
# the CUDA kernels of csrc/flash_attention_forward.cu, numbered as its
# `refiners_flash_attention_forward_kernel` entry numbers them
FORWARD_KERNELS = ("flash_fwd_narrow_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel")
# the CUDA kernels of csrc/flash_attention_backward.cu, (dK/dV, dQ) by dtype,
# for head_dim <= 128 (`backward_kernels` adds the wider heads)
BACKWARD_KERNELS = {
    torch.bfloat16: ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    torch.float16: ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    torch.float32: ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel"),
}
# bfloat16 and float16 at 128 < head_dim <= 512: one kernel for both entries
# (dQ blocks; dK and dV blocks in one grid)
WIDE_BACKWARD_KERNEL = "flash_bwd_wide_wgmma_kernel"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _default_scale(q: torch.Tensor, scale: float | None) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _causal_keep(lq: int, lk: int, device: torch.device) -> torch.Tensor:
    """(Lq, Lk) keep-mask: key j is admissible for query i iff j <= i + (Lk - Lq)."""
    rows = torch.arange(lq, device=device)[:, None]
    return torch.arange(lk, device=device)[None, :] <= rows + (lk - lq)


def _plain_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None,
    is_causal: bool,
    scale: float | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): float32 logits, bias added, masked scores -1e30, softmax
    weights cast to the input dtype before the product with V."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _default_scale(q, scale)
    if bias is not None:
        logits = logits + bias.float()
    if is_causal:
        logits = logits.masked_fill(~_causal_keep(q.shape[-2], k.shape[-2], q.device), MASKED_SCORE)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v), torch.logsumexp(logits, dim=-1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of `flash_attention`, over (B, H, L, D)."""
    return _plain_forward(q, k, v, bias, is_causal, scale)[0]


def flash_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `flash_attention_backward`: the kernels' recompute,
    not autograd of the forward (JAX: `_recompute_p_ds`, `_flash_backward`).

    P = exp(scale·QKᵀ − lse), forced to 0 outside the causal mask (so a
    causal row with no admissible key gets a zero gradient, as the JAX
    kernel gives it); delta = rowsum(dO∘O); dS = P∘(dP − delta); P and dS
    are rounded to the input dtype before their products; the scale is
    folded in at the end. Float32 throughout otherwise.
    """
    scale = _default_scale(q, scale)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(q32, k32.transpose(-1, -2)) * scale - lse.float()[..., None])
    if is_causal:
        p = p.masked_fill(~_causal_keep(q.shape[-2], k.shape[-2], q.device), 0.0)
    delta = (do32 * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale
    dq = torch.matmul(ds, k32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    head_dim: int = 64,
) -> torch.Tensor:
    """Plain version of `flash_attention_packed`: split heads, attend on the
    math path, merge heads."""
    h = q.shape[-1] // head_dim
    out = _attention(split_heads(q, h), split_heads(k, h), split_heads(v, h), is_causal=is_causal, scale=scale)
    return merge_heads(out)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_device_dtype(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the kernels take bfloat16, float16 or float32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )


def _check_heads(batch: int, heads: int, head_dim: int) -> None:
    if head_dim <= 0 or head_dim > 512 or head_dim % 8:
        raise ValueError(f"head_dim={head_dim} must be a multiple of 8 and at most 512")
    if batch * heads > 65535:
        raise ValueError(f"batch·heads={batch * heads} exceeds the grid's limit of 65535")


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, H, Lq, D), k and v (B, H, Lk, D) views the kernels can read."""
    _check_device_dtype(q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected (B, H, L, D) operands, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _check_heads(b, h, d)
    _check_layout(q=q, k=k, v=v)


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, x in tensors.items():
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {x.stride()}")
        # 16-byte vector loads: base and the other strides aligned to 8 elements
        if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples of 8, strides {x.stride()}")


def _head_strides(x: torch.Tensor, head_dim: int | None) -> tuple[int, int, int]:
    """(batch, head, row) strides of a (B, H, L, D) view, or, with `head_dim`,
    of a packed (B, L, H·D) tensor whose heads lie `head_dim` apart."""
    if head_dim is None:
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), head_dim, x.stride(1)


def _launch_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    bias: torch.Tensor | None,
    lse: torch.Tensor | None,
    is_causal: bool,
    scale: float,
    head_dim: int | None = None,
) -> None:
    """One launch of the forward kernel on checked operands: (B, H, L, D)
    views, or packed (B, L, H·D) tensors when `head_dim` is given (read in
    place: no views are made, which keeps the host's share of a short
    launch small). `bias` is float32 broadcast to (B, H, Lq, Lk), `lse` a
    (B, H, Lq) float32 buffer."""
    if head_dim is None:
        b, h, lq, d = q.shape
        lk = k.shape[2]
    else:
        b, lq, hd = q.shape
        h, d, lk = hd // head_dim, head_dim, k.shape[1]
    strides = [s for x in (q, k, v, out) for s in _head_strides(x, head_dim)]
    strides += list(bias.stride()) if bias is not None else [0, 0, 0, 0]
    with torch.cuda.device(q.device):
        err = load_library().refiners_flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bias.data_ptr() if bias is not None else None, lse.data_ptr() if lse is not None else None,
            DTYPE_CODES[q.dtype], b, h, d, lq, lk, c_longlongs(strides),
            scale, int(is_causal), stream(q),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: cudaError {err}")


def forward_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that a forward call on the card launches, as the C
    entry routes it: by dtype and head dim (a bias of either kind and an lse
    output are modes of each kernel). Builds the kernels if needed."""
    code = load_library().refiners_flash_attention_forward_kernel(DTYPE_CODES[dtype], head_dim)
    if code < 0:
        raise ValueError(f"the forward kernels do not take head_dim={head_dim}")
    return FORWARD_KERNELS[code]


def _launch_backward(
    entry: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    dq: torch.Tensor | None,
    dk: torch.Tensor | None,
    dv: torch.Tensor | None,
    is_causal: bool,
    scale: float,
) -> None:
    b, h, lq, d = q.shape
    grads = [x if x is not None else q for x in (dq, dk, dv)]  # strides of an unused output are not read
    strides = [s for x in (q, k, v, do, *grads) for s in x.stride()[:3]]

    def ptr(x: torch.Tensor | None) -> int | None:
        return x.data_ptr() if x is not None else None

    with torch.cuda.device(q.device):
        err = getattr(load_library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ptr(dq), ptr(dk), ptr(dv), DTYPE_CODES[q.dtype], b, h, d, lq, k.shape[2], c_longlongs(strides),
            scale, int(is_causal), stream(q),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel ({entry}) launch failed: cudaError {err}")


def _prepare_bias(bias: torch.Tensor | None, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor | None:
    """The bias as float32 on q's device, broadcast (stride 0) to (B, H, Lq, Lk)."""
    if bias is None:
        return None
    if bias.device != q.device:
        raise ValueError(f"bias must be on {q.device}, got {bias.device}")
    b, h, lq, _ = q.shape
    return torch.broadcast_to(bias.float(), (b, h, lq, k.shape[2]))


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    with_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Forward over (B, H, L, D) views: (out, lse), lse (B, H, Lq) float32
    (None without `with_lse`). `out` takes q's memory layout when q is dense,
    so a head view of a packed tensor gives a head view of a packed output.

    On CUDA tensors this launches the kernel (``flash_attention.launches``);
    on CPU tensors it runs the plain version. No autograd: see
    `flash_attention`.
    """
    if q.device.type == "cpu":
        out, lse = _plain_forward(q, k, v, bias, is_causal, scale)
        return out, lse if with_lse else None
    _check_operands(q, k, v)
    bias = _prepare_bias(bias, q, k)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32) if with_lse else None
    _launch_forward(q, k, v, out, bias, lse, is_causal, _default_scale(q, scale))
    flash_attention.launches += 1  # type: ignore[attr-defined]
    return out, lse


def flash_attention_bwd_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    is_causal: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by the dK/dV kernel, on checked CUDA views (see
    `flash_attention_backward`)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_backward("refiners_flash_attention_bwd_dkv", q, k, v, do, lse, delta, None, dk, dv, is_causal, scale)
    flash_attention_bwd_dkv.launches += 1  # type: ignore[attr-defined]
    return dk, dv


def flash_attention_bwd_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    is_causal: bool,
    scale: float,
) -> torch.Tensor:
    """dq by the dQ kernel, on checked CUDA views (see `flash_attention_backward`)."""
    dq = torch.empty_like(q)
    _launch_backward("refiners_flash_attention_bwd_dq", q, k, v, do, lse, delta, dq, None, None, is_causal, scale)
    flash_attention_bwd_dq.launches += 1  # type: ignore[attr-defined]
    return dq


def backward_kernels(dtype: torch.dtype, head_dim: int) -> tuple[str, str]:
    """The CUDA kernels (dK/dV, dQ) that a backward call on the card
    launches, as the C entries route them: by dtype and head dim."""
    if dtype != torch.float32 and head_dim > 128:
        return WIDE_BACKWARD_KERNEL, WIDE_BACKWARD_KERNEL
    return BACKWARD_KERNELS[dtype]


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention over (B, H, L, D) views, from the forward's
    output `o` and logsumexp `lse` (B, H, Lq) and the output gradient `do`.

    On CUDA tensors this computes delta = rowsum(dO∘O) in float32 (as the
    JAX package does outside its kernels) and launches the dK/dV and dQ
    kernels; the gradients take their operands' memory layouts. On CPU
    tensors it runs `flash_attention_backward_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, is_causal=is_causal, scale=scale)
    _check_operands(q, k, v)
    if do.dtype != q.dtype or do.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must match q {tuple(q.shape)} in shape and dtype, "
            f"lse {tuple(lse.shape)} its first three dims"
        )
    if do.stride(3) != 1 or do.data_ptr() % 16 or any(s % 8 for s in do.stride()[:3]):
        do = do.contiguous()
    _check_layout(do=do)
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    scale = _default_scale(q, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, is_causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, is_causal, scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd and public entries
# ---------------------------------------------------------------------------


def _needs_grad(*tensors: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors)


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` under autograd. Without a bias: the forward kernel
    with lse, the backward kernels. With a bias: the backward recomputes
    through autograd of `flash_attention_plain`, as the JAX package's `_bwd`
    does (the bias gradient needs the whole P matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal, scale):  # type: ignore[override]
        out, lse = flash_attention_forward(q, k, v, bias, is_causal, scale, with_lse=bias is None)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.is_causal, ctx.scale = is_causal, scale
        return out

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        q, k, v, bias, out, lse = ctx.saved_tensors
        if bias is None:
            return *flash_attention_backward(q, k, v, out, lse, g, ctx.is_causal, ctx.scale), None, None, None
        inputs = [x.detach().requires_grad_(need) for x, need in zip((q, k, v, bias), ctx.needs_input_grad)]
        with torch.enable_grad():
            recomputed = flash_attention_plain(*inputs, is_causal=ctx.is_causal, scale=ctx.scale)
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(recomputed, wanted, g))
        return *(next(grads) if x.requires_grad else None for x in inputs), None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over (B, H, L, D), with an optional additive bias
    broadcastable to (B, H, Lq, Lk).

    On CUDA tensors this launches the kernels (under autograd, with their
    backward), or raises; on CPU tensors it runs `flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias=bias, is_causal=is_causal, scale=scale)
    if _needs_grad(q, k, v, bias):
        return _FlashAttention.apply(q, k, v, bias, is_causal, scale)
    return flash_attention_forward(q, k, v, bias, is_causal, scale)[0]


def _check_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected (B, L, H·D) operands, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hd = q.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[2] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if head_dim <= 0 or hd % head_dim:
        raise ValueError(f"head_dim={head_dim} must divide {hd}")
    _check_heads(b, hd // head_dim, head_dim)


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, L, H·D) → a (B, H, L, D) view: splitting a unit-stride last dim never copies."""
    return split_heads(x, x.shape[-1] // head_dim)


class _FlashAttentionPacked(torch.autograd.Function):
    """`flash_attention_packed` under autograd: the forward kernel with lse
    and the backward kernels, both on (B, H, L, D) head views of the packed
    operands, so nothing is split or merged by copy (JAX: `_fwd_packed`,
    `_bwd_packed`)."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale, head_dim):  # type: ignore[override]
        q4, k4, v4 = (_heads(x, head_dim) for x in (q, k, v))
        out4, lse = flash_attention_forward(q4, k4, v4, None, is_causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out4, lse)
        ctx.is_causal, ctx.scale, ctx.head_dim = is_causal, scale, head_dim
        return merge_heads(out4)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        q, k, v, out4, lse = ctx.saved_tensors
        d = ctx.head_dim
        q4, k4, v4, g4 = (_heads(x, d) for x in (q, k, v, g))
        dq, dk, dv = flash_attention_backward(q4, k4, v4, out4, lse, g4, ctx.is_causal, ctx.scale)
        return merge_heads(dq), merge_heads(dk), merge_heads(dv), None, None, None


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    head_dim: int = 64,
) -> torch.Tensor:
    """Attention over packed q (B, Lq, H·D), k and v (B, Lk, H·D).

    On CUDA tensors this launches the kernels, or raises: without autograd
    the forward without lse (``flash_attention_packed.launches``), under
    autograd `_FlashAttentionPacked`. On CPU tensors it runs the plain
    version (there is no kernel for the CPU).
    """
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, is_causal=is_causal, scale=scale, head_dim=head_dim)
    _check_packed(q, k, v, head_dim)
    if _needs_grad(q, k, v):
        return _FlashAttentionPacked.apply(q, k, v, is_causal, scale, head_dim)
    _check_device_dtype(q, k, v)
    _check_layout(q=q, k=k, v=v)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    _launch_forward(q, k, v, out, None, None, is_causal, scale, head_dim=head_dim)
    flash_attention_packed.launches += 1  # type: ignore[attr-defined]
    return out


# ---------------------------------------------------------------------------
# decomposed relative-position forward (SAM's image encoder)
# ---------------------------------------------------------------------------


def _relpos_bias(v_rel: torch.Tensor, h_rel: torch.Tensor, lk: int) -> torch.Tensor:
    """The (B, H, Lq, Lk) float32 bias v_rel[q, k // kw] + h_rel[q, k % kw]."""
    b, h, lq, _ = v_rel.shape
    return (v_rel.float()[..., :, None] + h_rel.float()[..., None, :]).reshape(b, h, lq, lk)


def flash_attention_relpos_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    v_rel: torch.Tensor,
    h_rel: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of `flash_attention_relpos`: the O(Lq·Lk) float32 bias
    materialized, then the plain forward."""
    return flash_attention_plain(q, k, v, bias=_relpos_bias(v_rel, h_rel, k.shape[2]), scale=scale)


def _check_relpos(q: torch.Tensor, k: torch.Tensor, v_rel: torch.Tensor, h_rel: torch.Tensor) -> None:
    b, h, lq, _ = q.shape
    kh, kw = v_rel.shape[-1], h_rel.shape[-1]
    if v_rel.shape != (b, h, lq, kh) or h_rel.shape != (b, h, lq, kw):
        raise ValueError(f"v_rel {tuple(v_rel.shape)} and h_rel {tuple(h_rel.shape)} must be (B, H, Lq, kh), (B, H, Lq, kw)")
    if kh * kw != k.shape[2]:
        raise ValueError(f"decomposed bias {kh}x{kw} != kv length {k.shape[2]}")
    if max(kh, kw) > MAX_RELPOS_SIDE:
        raise ValueError(f"the relative-position kernel takes kh, kw <= {MAX_RELPOS_SIDE}, got {kh}x{kw}")
    for name, x in (("v_rel", v_rel), ("h_rel", h_rel)):
        if x.device != q.device or x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} on {q.device}, got {x.dtype} on {x.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {x.stride()}")


def flash_attention_relpos(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    v_rel: torch.Tensor,
    h_rel: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention over (B, H, L, D) views with SAM's decomposed relative-position
    bias, bias[q, k] = v_rel[q, k // kw] + h_rel[q, k % kw], for a key grid of
    kh × kw = Lk: v_rel (B, H, Lq, kh) over the key's row, h_rel (B, H, Lq, kw)
    over its column, both in q's dtype.

    On CUDA tensors this launches the kernel (``flash_attention_relpos.launches``),
    which never materializes the bias, or raises; the output is a (B, H, Lq, D)
    view of a (B, Lq, H, D) tensor, so merging its heads is free. There is no
    backward, as in the JAX package: under autograd on the card it raises
    `NotImplementedError`. On CPU tensors it runs `flash_attention_relpos_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, v_rel, h_rel, scale=scale)
    if _needs_grad(q, k, v, v_rel, h_rel):
        raise NotImplementedError("the relative-position flash kernel is inference only: it has no backward")
    _check_operands(q, k, v)
    _check_relpos(q, k, v_rel, h_rel)
    b, h, lq, d = q.shape
    lk, kh, kw = k.shape[2], v_rel.shape[-1], h_rel.shape[-1]
    out = torch.empty((b, lq, h, d), device=q.device, dtype=q.dtype).transpose(1, 2)
    strides = [s for x in (q, k, v, out, v_rel, h_rel) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = load_library().refiners_flash_attention_relpos_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), v_rel.data_ptr(), h_rel.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, d, lq, lk, kh, kw, c_longlongs(strides), _default_scale(q, scale), stream(q),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash attention relpos kernel launch failed: cudaError {err}")
    flash_attention_relpos.launches += 1  # type: ignore[attr-defined]
    return out


flash_attention_packed.launches = 0  # type: ignore[attr-defined]
flash_attention.launches = 0  # type: ignore[attr-defined]
flash_attention_relpos.launches = 0  # type: ignore[attr-defined]
flash_attention_bwd_dkv.launches = 0  # type: ignore[attr-defined]
flash_attention_bwd_dq.launches = 0  # type: ignore[attr-defined]
