"""The reference's plain building blocks: weights read by key, and the few
operations every model here is made of, in float32 (TF32 off) or, for the
control, with every product's inputs rounded to float8 e4m3.

The weights are read by the port's state-dict keys. With no source,
`Weights` records each key with the shape the reference expects and hands
back a tensor on the ``meta`` device: running a model that way lists its
keys and shapes, which is what the benchmark draws the weights from.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3fn


@contextmanager
def float32_products() -> Iterator[None]:
    """Products and convolutions of float32 tensors in float32, not TF32, inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` through float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in float32: the rounding of a float8 product's
    inputs."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Weights:
    """Tensors by key. `source` maps keys to tensors in any float dtype;
    they are read as float32 (rounded through float8 when `fp8`, for
    matrices and kernels) and kept. With no source, each read records its
    key and shape and returns a meta tensor (`shapes`)."""

    def __init__(self, source: dict[str, torch.Tensor] | None = None, fp8: bool = False) -> None:
        self.source = source
        self.fp8 = fp8
        self.shapes: dict[str, tuple[int, ...]] = {}
        self._cache: dict[str, torch.Tensor] = {}

    def __call__(self, key: str, *shape: int) -> torch.Tensor:
        if self.source is None:
            if self.shapes.setdefault(key, shape) != shape:
                raise ValueError(f"{key}: read as {shape} and as {self.shapes[key]}")
            return torch.empty(shape, device="meta")
        t = self._cache.get(key)
        if t is None:
            t = self.source[key]
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}: {tuple(t.shape)}, the reference reads {shape}")
            t = t.float()
            if self.fp8 and t.ndim >= 2:
                t = round_fp8(t)
            self._cache[key] = t
        return t


class Ops:
    """Products in float32, or with their inputs rounded to float8 (`fp8`)."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        if x.requires_grad:  # rounded in the forward, the gradient passed straight through
            return x + (round_fp8(x.detach()) - x.detach())
        return round_fp8(x)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        return F.linear(self.q(x), w, b)

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int = 1, padding: int = 0) -> torch.Tensor:
        return F.conv2d(self.q(x), w, b, stride=stride, padding=padding)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
        """Multi-head attention over (B, L, heads·d) inputs: softmax(q kᵀ / √d) v."""
        b, lq, dim = q.shape
        d = dim // heads
        q, k, v = (self.q(t).unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=1 / math.sqrt(d))
        return out.transpose(1, 2).reshape(b, lq, dim)


def group_norm(W: Weights, p: str, x: torch.Tensor, channels: int, eps: float) -> torch.Tensor:
    return F.group_norm(x, 32, W(f"{p}.weight", channels), W(f"{p}.bias", channels), eps)


def layer_norm(W: Weights, p: str, x: torch.Tensor, dim: int, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (dim,), W(f"{p}.weight", dim), W(f"{p}.bias", dim), eps)


def linear(W: Weights, ops: Ops, p: str, x: torch.Tensor, cout: int, cin: int, bias: bool = True) -> torch.Tensor:
    return ops.linear(x, W(f"{p}.weight", cout, cin), W(f"{p}.bias", cout) if bias else None)


def conv(W: Weights, ops: Ops, p: str, x: torch.Tensor, cout: int, cin: int, k: int, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return ops.conv(x, W(f"{p}.weight", cout, cin, k, k), W(f"{p}.bias", cout), stride=stride, padding=padding)


def sinusoidal(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) values → (..., dim): [cos | sin] of x · 10000^(-i / (dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = x.float()[..., None] * freqs
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
