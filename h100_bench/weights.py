"""A model's weights drawn from a seed, on the device, in the dtype they are
served in: one normal draw for all of them, then each tensor scaled in
place (matrices and kernels by 1/√fan-in, biases small, norms' scales about
1, embeddings at 0.02). The keys and shapes are the reference's
(`reference.diffusion.model_spec`), so the same seed gives the port and the
reference the same tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, tag: str) -> int:
    """A 60-bit seed for the stream `tag` of a run seeded by `seed`."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


def _scale(key: str, shape: tuple[int, ...]) -> tuple[float, float]:
    """(std, mean) of the tensor `key`."""
    if key.endswith("Encoder.weight") or key.endswith("Embedding.weight"):
        return 0.02, 0.0
    if key.endswith(".bias"):
        return 0.02, 0.0
    if len(shape) == 1:  # a norm's scale
        return 0.05, 1.0
    return 1 / math.sqrt(math.prod(shape[1:])), 0.0


def make(shapes: dict[str, tuple[int, ...]], seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The tensors of `shapes` (views of one buffer), drawn from `seed`."""
    keys = sorted(shapes)
    total = sum(math.prod(shapes[k]) for k in keys)
    generator = torch.Generator(device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
    out, offset = {}, 0
    with torch.no_grad():
        for key in keys:
            n = math.prod(shapes[key])
            t = flat[offset : offset + n].view(shapes[key])
            std, mean = _scale(key, shapes[key])
            t.mul_(std)
            if mean:
                t.add_(mean)
            out[key] = t
            offset += n
    return out
