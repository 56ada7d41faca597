"""Inference rewrite passes (chain surgery, reversible); counterpart of
``refiners_tpu/fluxion/optimization.py``.

Three opt-in passes, none applied automatically:

- ``fuse_group_norm_silu`` replaces every GroupNorm → SiLU pair (both
  halves of every UNet and VAE residual block) by a `FusedGroupNormSiLU`,
  two kernel launches on the card (``ops/group_norm.py``) in place of the
  float32 GroupNorm's eager passes and a separate SiLU;
- ``quantize_linears`` (``ops/quant.py``, re-exported here) swaps every large
  `fl.Linear` for an int8 `QuantizedLinear` (W8A8 by default);
- ``fuse_qkv_projections`` replaces a self-attention's three projections by
  one wide one; no kernel.

Fused layers share the replaced layers' tensors, so ``unfuse_*`` restores
the structure, the ``repr`` and every ``state_dict()`` key exactly. Measure
a pass on your card and shapes before adopting it: the JAX package recorded
both fusions as slower on its TPU, where XLA had already fused those ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.layers.attentions import SelfAttention
from refiners_tpu_torch.fluxion.layers.module import WeightedModule
from refiners_tpu_torch.ops.group_norm import group_norm_silu
from refiners_tpu_torch.ops.quant import QuantizedLinear, quantize_linears

__all__ = [
    "FusedGroupNormSiLU",
    "FusedQKVProjection",
    "QuantizedLinear",
    "fuse_group_norm_silu",
    "fuse_qkv_projections",
    "quantize_linears",
    "unfuse_group_norm_silu",
    "unfuse_qkv_projections",
]


class FusedQKVProjection(WeightedModule):
    """One (3·inner, in) projection replacing a Distribute of three Linears
    that read the same input (self-attention). `unfuse()` rebuilds the three
    Linears exactly."""

    def __init__(self, q: fl.Linear, k: fl.Linear, v: fl.Linear) -> None:
        super().__init__()
        assert q.in_features == k.in_features == v.in_features
        assert (q.bias is None) == (k.bias is None) == (v.bias is None)
        self.in_features = q.in_features
        self.splits = (q.out_features, q.out_features + k.out_features)
        self.out_features = q.out_features + k.out_features + v.out_features
        self.use_bias = q.bias is not None
        with torch.no_grad():
            self.weight = torch.nn.Parameter(torch.cat([q.weight, k.weight, v.weight]), q.weight.requires_grad)
            self.bias = (
                torch.nn.Parameter(torch.cat([q.bias, k.bias, v.bias]), q.bias.requires_grad) if self.use_bias else None
            )

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> tuple[torch.Tensor, ...]:
        # self-attention (checked when fusing): the three inputs are one tensor
        bias = self.bias.to(q_in.dtype) if self.bias is not None else None
        return F.linear(q_in, self.weight.to(q_in.dtype), bias).tensor_split(self.splits, dim=-1)

    def unfuse(self) -> fl.Distribute:
        linears = []
        bounds = (0, *self.splits, self.out_features)
        for lo, hi in zip(bounds, bounds[1:]):
            linear = fl.Linear(self.in_features, hi - lo, bias=self.use_bias, device="meta")
            with torch.no_grad():
                linear.weight = torch.nn.Parameter(self.weight[lo:hi].clone(), self.weight.requires_grad)
                if self.bias is not None:
                    linear.bias = torch.nn.Parameter(self.bias[lo:hi].clone(), self.bias.requires_grad)
            linears.append(linear)
        return fl.Distribute(*linears)


class FusedGroupNormSiLU(WeightedModule):
    """GroupNorm then SiLU as one fused op (``ops.group_norm.group_norm_silu``:
    K5a and K5b on the card). Shares the GroupNorm's weight and bias, so it
    can be applied after loading weights and reversed exactly by `unfuse()`."""

    def __init__(self, gn: fl.GroupNorm) -> None:
        super().__init__()
        self.channels = gn.channels
        self.num_groups = gn.num_groups
        self.eps = gn.eps
        self.weight = gn.weight
        self.bias = gn.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps)

    def unfuse(self) -> tuple[fl.GroupNorm, fl.SiLU]:
        gn = fl.GroupNorm(channels=self.channels, num_groups=self.num_groups, eps=self.eps, device="meta")
        gn.weight = self.weight
        gn.bias = self.bias
        return gn, fl.SiLU()


def _index(parent: fl.Chain, module: fl.Module) -> int:
    return next(i for i, m in enumerate(parent) if m is module)


def fuse_group_norm_silu(root: fl.Chain) -> int:
    """Fuse every GroupNorm whose next sibling is a SiLU under `root`, in
    place; returns the number fused. Apply after loading weights (the fused
    layer has its own key path) and reverse with `unfuse_group_norm_silu`
    before saving a state dict."""
    count = 0
    for gn, parent in list(root.walk(fl.GroupNorm, recurse=True)):
        siblings = list(parent)
        idx = _index(parent, gn)
        if idx + 1 >= len(siblings) or type(siblings[idx + 1]) is not fl.SiLU:
            continue
        parent.remove(siblings[idx + 1])
        parent.replace(gn, FusedGroupNormSiLU(gn))
        count += 1
    return count


def unfuse_group_norm_silu(root: fl.Chain) -> int:
    """Reverse `fuse_group_norm_silu`."""
    count = 0
    for fused, parent in list(root.walk(FusedGroupNormSiLU, recurse=True)):
        idx = _index(parent, fused)
        gn, silu = fused.unfuse()
        parent.replace(fused, gn)
        parent.insert(idx + 1, silu)
        count += 1
    return count


def fuse_qkv_projections(root: fl.Chain) -> int:
    """Fuse every self-attention whose three projections are plain Linears
    of one input width and one bias setting; returns the number fused.
    Adapted (wrapped or subclassed) projections are skipped."""
    count = 0
    for attn, _ in list(root.walk(SelfAttention, recurse=True)):
        distribute = attn.find(fl.Distribute)
        if distribute is None or len(distribute) != 3:
            continue
        q, k, v = list(distribute)
        if not all(type(m) is fl.Linear for m in (q, k, v)):
            continue
        if not (q.in_features == k.in_features == v.in_features and (q.bias is None) == (k.bias is None) == (v.bias is None)):
            continue
        attn.replace(distribute, FusedQKVProjection(q, k, v))
        count += 1
    return count


def unfuse_qkv_projections(root: fl.Chain) -> int:
    """Reverse `fuse_qkv_projections`."""
    count = 0
    for fused, parent in list(root.walk(FusedQKVProjection, recurse=True)):
        parent.replace(fused, fused.unfuse())
        count += 1
    return count
