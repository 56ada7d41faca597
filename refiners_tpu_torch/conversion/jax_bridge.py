"""Move a JAX-package ``state_dict()`` into the port.

The reverse of ``refiners_tpu/conversion/refiners_compat.py``: the two
packages share key paths and differ only in weight layouts, so the bridge
renames nothing and transposes by the port module that owns each weight:

- Linear, QuantizedLinear (int8) and FusedQKVProjection: (in, out) → (out, in);
- Conv2d: HWIO → OIHW;
- ConvTranspose2d: (kh, kw, in, out) → (in, out, kh, kw);
- everything else is copied (a QuantizedLinear's (1, out) scales, a
  FusedGroupNormSiLU's weight and bias).

So a JAX model after ``quantize_linears``, ``fuse_qkv_projections`` or
``fuse_group_norm_silu`` loads into the port after the same pass.

It takes numpy arrays (``np.asarray`` of the JAX arrays) and imports no JAX.
The NHWC ↔ NCHW helpers convert activations for comparisons between the two.
"""

from __future__ import annotations

import numpy as np
import torch

import refiners_tpu_torch.fluxion.layers as fl
from refiners_tpu_torch.fluxion.optimization import FusedQKVProjection, QuantizedLinear

_PERMUTATIONS = {
    fl.Linear: (1, 0),
    QuantizedLinear: (1, 0),
    FusedQKVProjection: (1, 0),
    fl.Conv2d: (3, 2, 0, 1),
    fl.ConvTranspose2d: (2, 3, 0, 1),
}


def _weight_layouts(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """Key → permutation from the JAX layout, for every weight that needs one."""
    layouts: dict[str, tuple[int, ...]] = {}
    for name, sub in module.named_modules(remove_duplicate=False):
        for layer_type, perm in _PERMUTATIONS.items():
            if isinstance(sub, layer_type):
                layouts[f"{name}.weight" if name else "weight"] = perm
    return layouts


def load_jax_state_dict(module: torch.nn.Module, arrays: dict[str, np.ndarray], strict: bool = True) -> None:
    """Load a JAX-package state dict (numpy arrays) into a port module.

    With `strict`, missing or unexpected keys raise KeyError. A shape that
    does not match after transposition raises ValueError.
    """
    own = module.state_dict(keep_vars=True)
    missing = [k for k in own if k not in arrays]
    unexpected = [k for k in arrays if k not in own]
    if strict and (missing or unexpected):
        raise KeyError(
            f"state mismatch for {type(module).__name__}: missing={missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} unexpected={unexpected[:8]}{'...' if len(unexpected) > 8 else ''}"
        )
    layouts = _weight_layouts(module)
    with torch.no_grad():
        for key, value in arrays.items():
            if key not in own:
                continue
            target = own[key]
            array = np.asarray(value)
            if key in layouts and array.ndim == len(layouts[key]):
                array = array.transpose(layouts[key])
            if tuple(array.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {key}: {array.shape} (from JAX) vs {tuple(target.shape)}")
            target.copy_(torch.tensor(array))


def nhwc_to_nchw(x: np.ndarray) -> np.ndarray:
    """(N, H, W, C) → (N, C, H, W)."""
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    """(N, C, H, W) → (N, H, W, C)."""
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))
