"""Operation counts of a cell's work, from the reference's own shapes.

`image_flops` and `sample_flops` count the reference on the ``meta``
device under `torch.utils.flop_counter.FlopCounterMode` (products and
convolutions; elementwise work is not counted), so the count is the
same whatever implements a layer. `attention_sites` lists the attention
calls at the shapes the cell fixes that the port routes to its flash
kernels (both sequences of at least 1024 tokens): the U-Net's
self-attention at its largest levels and the autoencoder's one-head
attention.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.reference import clip, unet, vae
from h100_bench.reference.nn import Ops, Weights

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12  # its HBM3, bytes/s
FLASH_MIN_SEQ = 1024


class _Grad(Weights):
    """Spec-mode weights that take gradients."""

    def __call__(self, key: str, *shape: int) -> torch.Tensor:
        return super().__call__(key, *shape).requires_grad_()


def _unet_inputs(cfg: dict[str, Any], batch: int, size: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    u = cfg["unet"]
    meta = {"device": "meta"}
    x = torch.empty((batch, u["in_channels"], size[0] // 8, size[1] // 8), **meta)
    ctx = torch.empty((batch, cfg["text_encoder"]["max_position_embeddings"], u["cross_attention_dim"]), **meta)
    pooled = time_ids = None
    if cfg["family"] == "sdxl":
        pooled = torch.empty((batch, cfg["text_encoder_2"]["projection_dim"]), **meta)
        time_ids = torch.empty((batch, 6), **meta)
    return x, torch.empty((batch,), **meta), ctx, pooled, time_ids


def image_flops(cfg: dict[str, Any], size: tuple[int, int]) -> float:
    """Operations of one image: both prompts encoded, the U-Net at the CFG
    batch of 2 at every step, one decode."""
    ops, steps = Ops(), cfg["solver"]["num_inference_steps"]
    tokens = torch.zeros((2, cfg["text_encoder"]["max_position_embeddings"]), dtype=torch.int64, device="meta")
    with FlopCounterMode(display=False) as text:
        if cfg["family"] == "sd1":
            clip.clip_l(Weights(), ops, tokens, cfg["text_encoder"])
        else:
            clip.sdxl_text(Weights(), ops, tokens, tokens, cfg["text_encoder"], cfg["text_encoder_2"])
    with FlopCounterMode(display=False) as step:
        unet.UNet(cfg["unet"], cfg["family"])(Weights(), ops, *_unet_inputs(cfg, 2, size))
    with FlopCounterMode(display=False) as decode:
        z = torch.empty((1, 4, size[0] // 8, size[1] // 8), device="meta")
        vae.decode(Weights(), ops, z, 1.0)
    return float(text.get_total_flops() + steps * step.get_total_flops() + decode.get_total_flops())


def sample_flops(cfg: dict[str, Any], size: tuple[int, int], batch: int) -> float:
    """Operations of one training sample: the U-Net's forward and backward at `batch`, divided by it."""
    x, t, ctx, pooled, time_ids = _unet_inputs(cfg, batch, size)
    with FlopCounterMode(display=False) as counter:
        out = unet.UNet(cfg["unet"], cfg["family"])(_Grad(), Ops(), x, t, ctx, pooled, time_ids)
        out.float().pow(2).mean().backward()
    return float(counter.get_total_flops()) / batch


def attention_sites(cfg: dict[str, Any], size: tuple[int, int], batch: int, decode: bool) -> list[tuple[int, ...]]:
    """(B, Lq, Lk, heads, d, calls) of each flash-routed attention of one
    U-Net call at `batch` (and of one decode, with `decode`)."""
    u, channels = cfg["unet"], cfg["unet"]["block_out_channels"]
    sites = []
    side_h, side_w = size[0] // 8, size[1] // 8
    for level, c in enumerate(channels):
        tokens = (side_h >> level) * (side_w >> level)
        depth = unet._depth(u, level)
        calls = (2 * u["layers_per_block"] + 1) * depth  # the down and up blocks of the level
        if level == len(channels) - 1:
            calls += max(depth, 1)  # the middle block's
        if tokens < FLASH_MIN_SEQ or not calls:
            continue
        heads = unet._heads(u, level)
        sites.append((batch, tokens, tokens, heads, c // heads, calls))
    if decode:
        tokens = side_h * side_w
        sites.append((1, tokens, tokens, 1, vae.SIZES[-1], 1))
    return sites


def attention_bound_s(sites: list[tuple[int, ...]], forward: float = 4.0, backward: float = 0.0) -> float:
    """The least time the sites' attention takes on the card: per call, the
    larger of operations (`forward` + `backward` multiply-adds ×2 per
    query-key-dimension) over the bf16 peak and bytes over the bandwidth."""
    total = 0.0
    for b, lq, lk, heads, d, calls in sites:
        ops = (forward + backward) * b * heads * lq * lk * d
        tensors = 2 * lq + 2 * lk if not backward else 4 * lq + 4 * lk  # q, k, v, o (and dO, dQ, dK, dV)
        nbytes = 2 * b * heads * d * tensors
        total += calls * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    return total
