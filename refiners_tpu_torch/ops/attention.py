"""Scaled dot-product attention: the plain PyTorch math path.

Counterpart of ``refiners_tpu/ops/attention.py``. Layout: (batch, heads, seq,
head_dim) for the 4-D entry points. Logits and softmax are float32, the
causal mask keeps key j for query i iff ``j <= i + (Lk - Lq)``, and the
softmax weights are cast to the query dtype before the product with V — the
numerics of the JAX package's XLA path.

On the card, attention whose query and key sequences are both at least
``FLASH_MIN_SEQ`` long goes to the hand-written kernels
(``ops.flash_attention``), in bfloat16, float16 or float32; this path serves
the rest (cross-attention over 77 text tokens, CLIP) and is the layers'
plain reference. SAM's relative-position attention takes its kernel on the
card at every length (`flash_auto_relpos`).
"""

from __future__ import annotations

import math

import torch

# Sequence length from which the attention layers route to the kernel; the
# same threshold as the JAX package's `_FLASH_MIN_SEQ`.
FLASH_MIN_SEQ = 1024

# Slice the query rows when the float32 logits buffer would exceed this.
# Rows are independent, so slicing does not change results.
_SLICE_BYTES = 256 * 1024 * 1024


def flash_auto(x: torch.Tensor, *seq_lens: int) -> bool:
    """Whether an attention call on `x` takes the kernel: only on the card,
    and only when every sequence is long enough."""
    return x.is_cuda and all(s >= FLASH_MIN_SEQ for s in seq_lens)


def flash_auto_relpos(x: torch.Tensor) -> bool:
    """Whether SAM's relative-position attention on `x` takes its kernel: on
    the card, at every sequence length and in every dtype (the plain path
    materializes an O(L²) float32 bias whatever the length), as the JAX
    package's `flash_auto_relpos` selects."""
    return x.is_cuda


def _attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    causal_offset: int | None,
    scale: float,
) -> torch.Tensor:
    """Unsliced attention; `causal_offset` is the global index of q's first row
    plus (Lk − Lq): row i attends keys j <= i + offset."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal_offset is not None:
        ql, kl = logits.shape[-2], logits.shape[-1]
        rows = torch.arange(ql, device=q.device)[:, None]
        keep = torch.arange(kl, device=q.device)[None, :] <= rows + causal_offset
        logits = logits.masked_fill(~keep, -math.inf)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -math.inf)
        else:
            logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    # operands of two dtypes (SAM's decoder mixes float32 prompts with a bf16
    # image embedding) multiply in the promoted dtype, as jnp.einsum does
    dtype = torch.promote_types(q.dtype, v.dtype)
    return torch.matmul(weights.to(dtype), v.to(dtype)).to(q.dtype)


def _attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention, query-sliced when the logits buffer would be large."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[-2], k.shape[-2]
    logits_bytes = math.prod(q.shape[:-2]) * lq * lk * 4
    n_chunks = max(1, min(lq, -(-logits_bytes // _SLICE_BYTES)))
    chunk = -(-lq // n_chunks)
    mask_rows = mask is not None and mask.ndim >= 2 and mask.shape[-2] == lq
    outs = []
    for start in range(0, lq, chunk):
        rows = slice(start, start + chunk)
        m = mask[..., rows, :] if mask_rows else mask  # type: ignore[index]
        offset = start + (lk - lq) if is_causal else None
        outs.append(_attention_dense(q[..., rows, :], k, v, m, offset, scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    use_flash: bool | None = None,
) -> torch.Tensor:
    """Attention over (B, H, Lq, D) / (B, H, Lk, D) tensors.

    `use_flash=None` picks the flash kernel by `flash_auto`; `True` calls
    ``ops.flash_attention.flash_attention`` with the mask as an additive
    bias (its plain version on CPU tensors); `False` takes the plain path.
    """
    assert q.ndim == 4, f"expected (B, H, L, D), got {tuple(q.shape)}"
    if use_flash is None:
        use_flash = flash_auto(q, q.shape[-2], k.shape[-2])
    if use_flash:
        from refiners_tpu_torch.ops.flash_attention import MASKED_SCORE, flash_attention

        bias = mask
        if bias is not None and bias.dtype == torch.bool:
            # boolean keep-mask → large negative additive bias. A row whose
            # keys are ALL masked gets uniform weights here (every score ties
            # at -1e30) where the plain path gives NaN, as in the JAX package.
            bias = torch.where(bias, 0.0, MASKED_SCORE).float()
        return flash_attention(q, k, v, bias=bias, is_causal=is_causal, scale=scale)
    return _attention(q, k, v, mask=mask, is_causal=is_causal, scale=scale)


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: torch.Tensor | None = None,
    is_causal: bool = False,
) -> torch.Tensor:
    """Reference-compatible entry point: 3-D (B, L, D) or 4-D (B, H, L, D)."""
    if query.ndim == 3:
        out = dot_product_attention(query[:, None], key[:, None], value[:, None], mask=attn_mask, is_causal=is_causal)
        return out[:, 0]
    return dot_product_attention(query, key, value, mask=attn_mask, is_causal=is_causal)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H·D) → (B, H, L, D)."""
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, D) → (B, L, H·D)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)
