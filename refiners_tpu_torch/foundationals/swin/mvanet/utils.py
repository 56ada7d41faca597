"""MVANet's building blocks; counterpart of
``refiners_tpu/foundationals/swin/mvanet/utils.py``.

Feature maps are NCHW and multi-view stacks (B, V, C, H, W) here (the JAX
package's are NHWC and (B, V, H, W, C)); attention sequences keep the
seq-first (L, B, C) layout of both packages, so weights load by key.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.utils import interpolate


class Unflatten(fl.Module):
    """Split `dim` into `sizes` (one of them may be -1)."""

    def __init__(self, dim: int, sizes: tuple[int, ...]) -> None:
        super().__init__()
        self.dim = dim
        self.sizes = sizes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(self.dim, self.sizes)


class Interpolate(fl.Module):
    """Resize an NCHW map to a fixed size."""

    def __init__(self, size: tuple[int, ...], mode: str = "bilinear") -> None:
        super().__init__()
        self.size = tuple(size)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interpolate(x, self.size, mode=self.mode)  # type: ignore[arg-type]


class Rescale(fl.Module):
    """Resize an NCHW map by a scale factor (sizes rounded down)."""

    def __init__(self, scale_factor: float, mode: str = "nearest") -> None:
        super().__init__()
        self.scale_factor = scale_factor
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = int(x.shape[2] * self.scale_factor), int(x.shape[3] * self.scale_factor)
        return interpolate(x, (h, w), mode=self.mode)


class BatchNorm2d(fl.WeightedModule):
    """Inference-mode batch norm over the channels (dim 1), in float32."""

    running_mean: torch.Tensor
    running_var: torch.Tensor
    num_batches_tracked: torch.Tensor

    def __init__(self, num_features: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.num_features = num_features
        self.eps = 1e-5
        self.weight = rng.ones((num_features,), device=device, dtype=dtype)
        self.bias = rng.zeros((num_features,), device=device, dtype=dtype)
        dtype = dtype or torch.float32
        self.register_buffer("running_mean", torch.zeros((num_features,), device=device, dtype=dtype))
        self.register_buffer("running_var", torch.ones((num_features,), device=device, dtype=dtype))
        # kept for the checkpoint's layout only
        self.register_buffer("num_batches_tracked", torch.zeros((), device=device, dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (-1, 1, 1)
        inv = torch.rsqrt(self.running_var.float() + self.eps).reshape(shape)
        y = (x.float() - self.running_mean.float().reshape(shape)) * inv
        return (y * self.weight.float().reshape(shape) + self.bias.float().reshape(shape)).to(x.dtype)


class PReLU(fl.WeightedModule, fl.Activation):
    """Parametric ReLU with one learned slope."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.full((1,), 0.25, device=device, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class PatchSplit(fl.Chain):
    """(B, C, H, W) → (B, 4, C, H/2, W/2): top-left, top-right, bottom-left, bottom-right."""

    def __init__(self) -> None:
        super().__init__(
            Unflatten(2, (2, -1)),  # (B, C, 2, H/2, W)
            Unflatten(4, (2, -1)),  # (B, C, 2, H/2, 2, W/2)
            fl.Permute(0, 2, 4, 1, 3, 5),
            fl.Flatten(1, 2),
        )


class PatchMerge(fl.Chain):
    """(B, 4, C, H, W) → (B, C, 2H, 2W), the inverse of `PatchSplit`."""

    def __init__(self) -> None:
        super().__init__(
            Unflatten(1, (2, 2)),  # (B, 2, 2, C, H, W)
            fl.Permute(0, 3, 1, 4, 2, 5),  # (B, C, 2, H, 2, W)
            fl.Flatten(2, 3),
            fl.Flatten(3, 4),
        )


class FeedForward(fl.Residual):
    def __init__(self, emb_dim: int, device: Any = None) -> None:
        super().__init__(
            fl.Linear(in_features=emb_dim, out_features=2 * emb_dim, device=device),
            fl.ReLU(),
            fl.Linear(in_features=2 * emb_dim, out_features=emb_dim, device=device),
        )


class _GetArgs(fl.Parallel):
    def __init__(self, n: int) -> None:
        super().__init__(
            fl.Chain(fl.GetArg(0), fl.Slicing(dim=0, start=n, end=n + 1), fl.Squeeze(0)),
            fl.Chain(fl.GetArg(1), fl.Slicing(dim=0, start=n, end=n + 1), fl.Squeeze(0)),
            fl.Chain(fl.GetArg(1), fl.Slicing(dim=0, start=n, end=n + 1), fl.Squeeze(0)),
        )


class MultiheadAttention(fl.WeightedModule):
    """``torch.nn.MultiheadAttention``'s computation over seq-first (L, B, C)
    tensors, with its weight layout (`in_proj_weight` (3C, C), `out_proj`).
    Logits and softmax in float32; plain PyTorch, as the JAX package's
    einsum attention."""

    def __init__(self, embedding_dim: int, num_heads: int, device: Any = None, dtype: Any = None) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.num_heads = num_heads
        bound = 1.0 / math.sqrt(embedding_dim)
        self.in_proj_weight = rng.init_uniform((3 * embedding_dim, embedding_dim), bound, device=device, dtype=dtype)
        self.in_proj_bias = rng.zeros((3 * embedding_dim,), device=device, dtype=dtype)
        self.out_proj = fl.Linear(embedding_dim, embedding_dim, device=device, dtype=dtype)

    @property
    def weight(self) -> torch.Tensor:  # type: ignore[override]
        return self.in_proj_weight

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        L, B, C = q.shape
        S = k.shape[0]
        h, dh = self.num_heads, C // self.num_heads
        wq, wk, wv = self.in_proj_weight.to(q.dtype).chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.to(q.dtype).chunk(3, dim=0)
        qp = F.linear(q, wq, bq).reshape(L, B * h, dh).transpose(0, 1)
        kp = F.linear(k, wk, bk).reshape(S, B * h, dh).transpose(0, 1)
        vp = F.linear(v, wv, bv).reshape(S, B * h, dh).transpose(0, 1)
        logits = torch.bmm((qp / math.sqrt(dh)).float(), kp.float().transpose(1, 2))
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.bmm(weights, vp).transpose(0, 1).reshape(L, B, C)
        return self.out_proj(out)


class PatchwiseCrossAttention(fl.Chain):
    """(4, HW, B, C) × (4, HW', B, C) → (4, HW, B, C): tile n attends to its own keys."""

    def __init__(self, d_model: int, num_heads: int, device: Any = None) -> None:
        super().__init__(
            fl.Concatenate(
                *(
                    fl.Chain(
                        _GetArgs(n),
                        MultiheadAttention(d_model, num_heads, device=device),
                    )
                    for n in range(4)
                ),
            ),
            Unflatten(0, (4, -1)),
        )


class Pool(fl.Module):
    """Average pooling of an NCHW map by `ratio`."""

    def __init__(self, ratio: int) -> None:
        super().__init__()
        self.ratio = ratio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[2] % self.ratio == 0 and x.shape[3] % self.ratio == 0
        return F.avg_pool2d(x, self.ratio)


class MultiPool(fl.Concatenate):
    """NCHW input → (B, Σ h'·w', 1, C): the pooled maps as one sequence."""

    def __init__(self, pool_ratios: list[int]) -> None:
        super().__init__(
            *(
                fl.Chain(
                    Pool(pool_ratio),
                    fl.Flatten(2),  # (B, C, h'w')
                    fl.Transpose(1, 2),  # (B, h'w', C)
                    fl.Unsqueeze(2),  # (B, h'w', 1, C)
                )
                for pool_ratio in pool_ratios
            ),
            dim=1,
        )
