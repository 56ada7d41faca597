"""Refiners-layout checkpoint compatibility; counterpart of
``refiners_tpu/conversion/refiners_compat.py``.

The port's chains reproduce the reference's structure and naming, and its
weights keep torch's layouts, so a refiners-layout state dict loads as it
is. What is left is a check: every key in the target, and every tensor of
the target's shape (no transpose can hide a mismatch here, as one could in
the JAX package). The target is only read for its keys and shapes, so it
may be built with ``device="meta"``.
"""

from __future__ import annotations

from typing import Any

import torch

from refiners_tpu_torch.conversion.utils import as_tensor


def convert_refiners_state_dict(
    state: dict[str, Any], target: torch.nn.Module, strict: bool = True
) -> dict[str, torch.Tensor]:
    """`state` as torch tensors, checked against `target`'s keys and shapes.

    Keys `target` lacks raise KeyError under `strict` and are dropped
    otherwise; under `strict` a key of `target` that `state` lacks raises
    KeyError too. A shape that differs from the target's raises ValueError.
    """
    own = target.state_dict()
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key not in own:
            if strict:
                raise KeyError(f"unexpected key {key!r} (not present in target module)")
            continue
        tensor = as_tensor(value)
        if tuple(tensor.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(tensor.shape)} vs {tuple(own[key].shape)} in target")
        out[key] = tensor
    if strict:
        missing = [k for k in own if k not in out]
        if missing:
            raise KeyError(f"missing keys for target: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    return out


def load_reference_state_dict(target: torch.nn.Module, state: dict[str, Any], strict: bool = True) -> None:
    target.load_state_dict(convert_refiners_state_dict(state, target, strict=strict), strict=strict)
