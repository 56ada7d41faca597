"""Flash attention over packed (B, L, H·D) operands: hand-written Hopper kernel.

Replaces the TPU kernel ``refiners_tpu/ops/flash_attention.py:_flash_kernel_packed``
(entry ``flash_attention_packed``), which serves the SDXL path's long
self-attention sites: 10 UNet sites at seq 4096 and 60 at seq 1024 (d = 64),
and the VAE decoder's mid-block site at seq 16384 (1 head, d = 512).

The kernel is ``refiners_tpu_torch/csrc/flash_attention_packed.cu``. On the
H100 it is bound by tensor-core throughput at seq ≥ 1024 with d = 64, and by
shared memory per block at d = 512; its header says what this first design
does about each. The TPU kernel's lane-width head grouping (``_packed_n_sub``
and its flat fallback) does not exist here: the kernel reads each head
through the strides it is given.

Beside the kernel: ``flash_attention_packed_plain``, the plain PyTorch
version of the same function, and a launch counter,
``flash_attention_packed.launches``, which grows by one per kernel launch.
"""

from __future__ import annotations

import math

import torch

from refiners_tpu_torch.ops.attention import _attention, merge_heads, split_heads

_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def flash_attention_packed_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    head_dim: int = 64,
) -> torch.Tensor:
    """Plain version: split heads, attend on the math path, merge heads."""
    h = q.shape[-1] // head_dim
    out = _attention(split_heads(q, h), split_heads(k, h), split_heads(v, h), is_causal=is_causal, scale=scale)
    return merge_heads(out)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"q, k, v must be on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes bfloat16 or float16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"expected (B, L, H·D) operands, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hd = q.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[2] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if head_dim <= 0 or head_dim > 512 or head_dim % 8 or hd % head_dim:
        raise ValueError(f"head_dim={head_dim} must be a multiple of 8, at most 512, and divide {hd}")
    if b * (hd // head_dim) > 65535:
        raise ValueError(f"batch·heads={b * (hd // head_dim)} exceeds the grid's limit of 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {x.stride()}")
        # 16-byte vector loads: base and row/batch strides aligned to 8 elements
        if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples of 8, strides {x.stride()}")
    if any(x.requires_grad for x in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError("flash_attention_packed has no backward kernel yet; call it under inference_mode")


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool = False,
    scale: float | None = None,
    head_dim: int = 64,
) -> torch.Tensor:
    """Attention over packed q (B, Lq, H·D), k and v (B, Lk, H·D).

    On CUDA tensors this launches the hand-written kernel, or raises; on CPU
    tensors it runs the plain version (there is no kernel for the CPU).
    """
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, is_causal=is_causal, scale=scale, head_dim=head_dim)
    _check(q, k, v, head_dim)
    from refiners_tpu_torch.ops.build import load_library

    lib = load_library()
    b, lq, hd = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, hd), device=q.device, dtype=q.dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.refiners_flash_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            b, hd // head_dim, head_dim, lq, lk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            scale, int(is_causal), stream,
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"flash_attention_packed kernel launch failed: cudaError {err}")
    flash_attention_packed.launches += 1  # type: ignore[attr-defined]
    return out


flash_attention_packed.launches = 0  # type: ignore[attr-defined]
