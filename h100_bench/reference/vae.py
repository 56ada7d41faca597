"""The Stable Diffusion KL-f8 autoencoder (arXiv:2112.10752) in plain
PyTorch, read by the port's state-dict keys. Serving runs the decoder only;
the encoder is here so that the keys the benchmark draws cover the whole
model that the port loads. As in the port, the resnets' GroupNorms take
eps 1e-5 and the others 1e-6 (the published model uses 1e-6 throughout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench.reference.nn import Ops, Weights, conv, group_norm, linear

SIZES = (128, 256, 512, 512, 512)


def resnet(W: Weights, ops: Ops, p: str, x: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    h = F.silu(group_norm(W, f"{p}.Chain.GroupNorm_1", x, cin, 1e-5))
    h = conv(W, ops, f"{p}.Chain.Conv2d_1", h, cout, cin, 3, padding=1)
    h = F.silu(group_norm(W, f"{p}.Chain.GroupNorm_2", h, cout, 1e-5))
    h = conv(W, ops, f"{p}.Chain.Conv2d_2", h, cout, cout, 3, padding=1)
    return h + (x if cin == cout else conv(W, ops, f"{p}.Conv2d", x, cout, cin, 1))


def attention(W: Weights, ops: Ops, p: str, x: torch.Tensor) -> torch.Tensor:
    """x + one-head self-attention over the pixels of GroupNorm(x)."""
    b, c, hh, ww = x.shape
    h = group_norm(W, f"{p}.GroupNorm", x, c, 1e-6).flatten(2).transpose(1, 2)
    a = f"{p}.SelfAttention2d"
    q, k, v = (linear(W, ops, f"{a}.Distribute.Linear_{i}", h, c, c) for i in (1, 2, 3))
    h = linear(W, ops, f"{a}.Linear", ops.attention(q, k, v, 1), c, c)
    return x + h.transpose(1, 2).reshape(b, c, hh, ww)


def decode(W: Weights, ops: Ops, z: torch.Tensor, scale: float) -> torch.Tensor:
    """Latents (B, 4, h, w) → images (B, 3, 8h, 8w) in about [-1, 1]."""
    sizes = SIZES[::-1]
    x = conv(W, ops, "Decoder.Conv2d_1", z / scale, 4, 4, 1)
    x = conv(W, ops, "Decoder.Conv2d_2", x, sizes[0], 4, 3, padding=1)
    p = "Decoder.Chain_1.Chain_1"
    x = resnet(W, ops, f"{p}.Resnet_1", x, sizes[0], sizes[0])
    x = attention(W, ops, f"{p}.Residual", x)
    x = resnet(W, ops, f"{p}.Resnet_2", x, sizes[0], sizes[0])
    for i in range(1, len(sizes)):
        p = f"Decoder.Chain_1.Chain_{i + 1}"
        for j in range(3):
            x = resnet(W, ops, f"{p}.Resnet_{j + 1}", x, x.shape[1], sizes[i])
        if i < 4:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = conv(W, ops, f"{p}.Upsample.Conv2d", x, sizes[i], sizes[i], 3, padding=1)
    x = F.silu(group_norm(W, "Decoder.Chain_2.GroupNorm", x, sizes[-1], 1e-6))
    return conv(W, ops, "Decoder.Chain_2.Conv2d", x, 3, sizes[-1], 3, padding=1)


def encode(W: Weights, ops: Ops, x: torch.Tensor, scale: float) -> torch.Tensor:
    """Images (B, 3, H, W) in [-1, 1] → the latents' mean, scaled."""
    x = conv(W, ops, "Encoder.Conv2d", x, SIZES[0], 3, 3, padding=1)
    for i, size in enumerate(SIZES):
        p = f"Encoder.Chain_1.Chain_{i + 1}"
        x = resnet(W, ops, f"{p}.Resnet_1", x, x.shape[1], size)
        if i == len(SIZES) - 1:
            x = attention(W, ops, f"{p}.Residual", x)
        x = resnet(W, ops, f"{p}.Resnet_2", x, size, size)
        if i < 3:
            x = conv(W, ops, f"{p}.Downsample.Conv2d", F.pad(x, (0, 1, 0, 1)), size, size, 3, stride=2)
    x = F.silu(group_norm(W, "Encoder.Chain_2.GroupNorm", x, SIZES[-1], 1e-6))
    x = conv(W, ops, "Encoder.Chain_2.Conv2d", x, 8, SIZES[-1], 3, padding=1)
    return scale * conv(W, ops, "Encoder.Chain_3.Conv2d", x, 8, 8, 1)[:, :4]
