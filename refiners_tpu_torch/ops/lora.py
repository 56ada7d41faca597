"""The LoRAs of one Linear added into its output in place: two hand-written
Hopper kernels (``csrc/lora.cu``) with their plain version.

No TPU kernel is replaced: the JAX package leaves a LoRA to XLA
(``refiners_tpu/fluxion/adapters/lora.py``, the target and its
``Chain(down, up, Multiply)`` branches under a ``Sum``), and XLA fuses the
chain. Run eagerly, that ``Sum`` is ten launches per Linear call with two
LoRAs, eight of them full-width passes over the target's output.
``LoraAdapter.forward`` takes this route instead where the kernels apply,
two launches per call whatever the number of LoRAs:

- ``lora_down_kernel``: H = x [D₁; …; Dₙ]ᵀ, one pass over x for every LoRA
  (each LoRA's ranks padded to 16 columns of H), summed in float32, each
  LoRA's columns scaled by its sᵢ in float32 and rounded once to x's dtype;
- ``lora_up_add_kernel``: y += Σᵢ (sᵢ Hᵢ) Uᵢᵀ, one pass over y: the products
  in float32 on the tensor cores, y added in float32 and rounded once.

Both read every LoRA's weights where they lie: no weight is copied,
concatenated or scaled, in memory or per call. What bounds them is memory:
x read once, y read and written once (2 · N · in + 4 · N · out bytes in
bf16); H and the weights are small.

``lora_add_`` runs ``lora_add_plain`` on a tensor that is not on the card
(float32 throughout, cast back into y); on a CUDA tensor it launches the
kernels or raises. Launch counter: ``lora_add_.launches``, one a call.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from refiners_tpu_torch.ops.build import DTYPE_CODES, load_library, stream

MAX_LORAS = 4
# 16-column steps of the kernel's products: the ranks, each rounded up to 16, at most 512 in all
MAX_RANK_STEPS = 32
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def _rank_steps(ups: Sequence[torch.Tensor]) -> int:
    return sum(-(-u.shape[1] // 16) for u in ups)


def lora_add_plain(
    y: torch.Tensor,
    x: torch.Tensor,
    downs: Sequence[torch.Tensor],
    ups: Sequence[torch.Tensor],
    scales: Sequence[float],
) -> torch.Tensor:
    """y += Σᵢ scales[i] · (x downs[i]ᵀ) ups[i]ᵀ in place, computed in float32
    and cast back into y once; returns y."""
    acc = y.float()
    xf = x.float()
    for down, up, scale in zip(downs, ups, scales, strict=True):
        acc = acc + scale * ((xf @ down.float().t()) @ up.float().t())
    return y.copy_(acc)


def refusal(
    y: torch.Tensor | None,
    x: torch.Tensor,
    downs: Sequence[torch.Tensor],
    ups: Sequence[torch.Tensor],
    device_type: str = "cuda",
) -> str | None:
    """Why the kernel does not take these tensors, or None where it does.
    `y` None checks everything but the output (a Linear's output is fresh and
    contiguous). The kernel runs on CUDA devices; the CPU tests pass
    `device_type="cpu"` to reach the checks that follow."""
    tensors = [x, *downs, *ups] + ([y] if y is not None else [])
    if not 1 <= len(downs) == len(ups) <= MAX_LORAS:
        return f"the kernel takes 1 to {MAX_LORAS} LoRAs, got {len(downs)} downs and {len(ups)} ups"
    if any(type(t) not in (torch.Tensor, torch.nn.Parameter) for t in tensors):
        return "the kernel takes plain tensors (no DTensor or other subclass)"
    if any(t.device.type != device_type or t.device != x.device for t in tensors):
        return f"every tensor must be on one {device_type} device, got {sorted({str(t.device) for t in tensors})}"
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype for t in tensors):
        return f"the kernel takes bfloat16 or float16 tensors of one dtype, got {sorted({str(t.dtype) for t in tensors})}"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *downs, *ups)):
        return "the kernel has no backward: x and the LoRA weights must not require grad"
    if x.ndim == 0 or x.numel() == 0:
        return f"x must have rows, got {tuple(x.shape)}"
    out, features = ups[0].shape[0], x.shape[-1]
    for down, up in zip(downs, ups):
        if down.ndim != 2 or up.ndim != 2 or down.shape[1] != features or up.shape != (out, down.shape[0]):
            return f"down (rank, {features}) and up ({out}, rank) expected, got {tuple(down.shape)}, {tuple(up.shape)}"
        if not (down.is_contiguous() and up.is_contiguous()) or down.data_ptr() % 16:
            return "every down and up weight must be contiguous, each down 16-byte-aligned"
    if _rank_steps(ups) > MAX_RANK_STEPS:
        return f"the ranks, each rounded up to 16, must add to at most {16 * MAX_RANK_STEPS}"
    if out % 8 or features % 8:
        return f"in and out features must be multiples of 8, got {features} and {out}"
    if y is not None:
        if y.shape != (*x.shape[:-1], out) or not y.is_contiguous() or y.data_ptr() % 16:
            return f"y must be a contiguous, 16-byte-aligned {(*x.shape[:-1], out)}, got {tuple(y.shape)}"
    return None


def lora_add_(
    y: torch.Tensor,
    x: torch.Tensor,
    downs: Sequence[torch.Tensor],
    ups: Sequence[torch.Tensor],
    scales: Sequence[float],
) -> torch.Tensor:
    """y (…, out) += Σᵢ scales[i] · (x downs[i]ᵀ) ups[i]ᵀ in place, x (…, in)
    of y's leading shape (any strides: a layout TMA cannot read is copied
    first), downs[i] (rᵢ, in), ups[i] (out, rᵢ); returns y.

    On CUDA tensors this launches the down kernel, then the up-add kernel
    (``lora_add_.launches`` counts the pair); on any other device it runs
    `lora_add_plain`."""
    if not y.is_cuda:
        return lora_add_plain(y, x, downs, ups, scales)
    if (reason := refusal(y, x, downs, ups)) is not None:
        raise ValueError(f"lora_add_: {reason}")
    rows = x.reshape(-1, x.shape[-1])
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        rows = rows.clone(memory_format=torch.contiguous_format)
    up_add_(y, down(rows, downs, scales), ups)
    lora_add_.launches += 1  # type: ignore[attr-defined]
    return y


def h_width(ranks: Sequence[int]) -> int:
    """Columns of the H that `down` writes: the ranks, each rounded up to 16,
    then to 32, 64 or a multiple of 128 (the down kernel's chunks)."""
    k = 16 * sum(-(-r // 16) for r in ranks)
    return 32 if k <= 32 else 64 if k <= 64 else -(-k // 128) * 128


def down(rows: torch.Tensor, downs: Sequence[torch.Tensor], scales: Sequence[float]) -> torch.Tensor:
    """The down kernel alone: (N, `h_width`) H of contiguous, 16-byte-aligned
    `rows` (N, in), in their dtype: LoRA i's columns, from the next multiple
    of 16, hold scales[i] · rows downs[i]ᵀ, summed and scaled in float32 and
    rounded once."""
    count = len(downs)
    ranks = (ctypes.c_int * count)(*(d.shape[0] for d in downs))
    h = torch.empty((rows.shape[0], h_width(list(ranks))), device=rows.device, dtype=rows.dtype)
    with torch.cuda.device(rows.device):
        err = load_library().refiners_lora_down(
            rows.data_ptr(), rows.shape[0], rows.shape[1], rows.stride(0), DTYPE_CODES[rows.dtype], count,
            (ctypes.c_void_p * count)(*(d.data_ptr() for d in downs)), ranks,
            (ctypes.c_float * count)(*(float(s) for s in scales)), h.data_ptr(), h.shape[1], stream(rows),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"LoRA down kernel launch failed: cudaError {err}")
    return h


def up_add_(y: torch.Tensor, h: torch.Tensor, ups: Sequence[torch.Tensor]) -> None:
    """The up-add kernel alone: y += Σᵢ Hᵢ ups[i]ᵀ, Hᵢ LoRA i's (scaled)
    columns of `down`'s output."""
    count = len(ups)
    with torch.cuda.device(y.device):
        err = load_library().refiners_lora_up_add(
            y.data_ptr(), y.numel() // y.shape[-1], y.shape[-1], DTYPE_CODES[y.dtype], count, h.data_ptr(), h.shape[1],
            (ctypes.c_void_p * count)(*(u.data_ptr() for u in ups)),
            (ctypes.c_int * count)(*(u.shape[1] for u in ups)),
            stream(y),
        )  # fmt: skip
    if err != 0:
        raise RuntimeError(f"LoRA up-add kernel launch failed: cudaError {err}")


lora_add_.launches = 0  # type: ignore[attr-defined]
