"""The latent-diffusion U-Net (arXiv:2112.10752; SDXL: arXiv:2307.01952) in
plain PyTorch, from the widths of a published diffusers ``unet/config.json``
and read by the port's state-dict keys.

Two key layouts: ``sd1`` (convolutional projections around each
transformer, a ``Sum`` around the middle block, the output head under
``Chain``) and ``sdxl`` (linear projections, the pooled-text and time-ids
embedding added to the timestep's, ``MiddleBlock`` and ``OutputBlock`` at
the top). Departures from diffusers that the port makes, and the reference
follows: the timestep embedding is [cos | sin] (``flip_sin_to_cos``), the
middle block's output gets the (zero) mid-block residual, and
normalizations run in float32 whatever the weights' dtype.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from h100_bench.reference.nn import Ops, Weights, conv, group_norm, layer_norm, linear, sinusoidal


def _heads(cfg: dict[str, Any], level: int) -> int:
    heads = cfg["attention_head_dim"]  # diffusers' name for the number of heads
    return heads[level] if isinstance(heads, list) else heads


def _depth(cfg: dict[str, Any], level: int) -> int:
    """Transformer layers at `level`; 0 where the level has no cross-attention."""
    if "CrossAttn" not in cfg["down_block_types"][level]:
        return 0
    layers = cfg.get("transformer_layers_per_block", 1)
    return layers[level] if isinstance(layers, list) else layers


def resblock(W: Weights, ops: Ops, p: str, x: torch.Tensor, temb: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    h = F.silu(group_norm(W, f"{p}.Chain.GroupNorm_1", x, cin, 1e-5))
    h = conv(W, ops, f"{p}.Chain.RangeAdapter2d.Conv2d", h, cout, cin, 3, padding=1)
    t = linear(W, ops, f"{p}.Chain.RangeAdapter2d.Chain.Linear", F.silu(temb), cout, temb.shape[-1])
    h = F.silu(group_norm(W, f"{p}.Chain.GroupNorm_2", h + t[:, :, None, None], cout, 1e-5))
    h = conv(W, ops, f"{p}.Chain.Conv2d", h, cout, cout, 3, padding=1)
    return h + (x if cin == cout else conv(W, ops, f"{p}.Conv2d", x, cout, cin, 1))


def transformer_block(W: Weights, ops: Ops, p: str, x: torch.Tensor, ctx: torch.Tensor, c: int, heads: int) -> torch.Tensor:
    """Pre-norm self-attention, cross-attention on the text, GeGLU feed-forward."""
    h = layer_norm(W, f"{p}.Residual_1.LayerNorm", x, c)
    a = f"{p}.Residual_1.SelfAttention"
    q, k, v = (linear(W, ops, f"{a}.Distribute.Linear_{i}", h, c, c, bias=False) for i in (1, 2, 3))
    x = x + linear(W, ops, f"{a}.Linear", ops.attention(q, k, v, heads), c, c)
    h = layer_norm(W, f"{p}.Residual_2.LayerNorm", x, c)
    a, cd = f"{p}.Residual_2.Attention", ctx.shape[-1]
    q = linear(W, ops, f"{a}.Distribute.Linear_1", h, c, c, bias=False)
    k = linear(W, ops, f"{a}.Distribute.Linear_2", ctx, c, cd, bias=False)
    v = linear(W, ops, f"{a}.Distribute.Linear_3", ctx, c, cd, bias=False)
    x = x + linear(W, ops, f"{a}.Linear", ops.attention(q, k, v, heads), c, c)
    h = layer_norm(W, f"{p}.Residual_3.LayerNorm", x, c)
    value, gate = linear(W, ops, f"{p}.Residual_3.Linear_1", h, 8 * c, c).chunk(2, dim=-1)
    return x + linear(W, ops, f"{p}.Residual_3.Linear_2", value * F.gelu(gate), c, 4 * c)


def spatial_transformer(W: Weights, ops: Ops, p: str, x: torch.Tensor, ctx: torch.Tensor, heads: int, depth: int,
                        linear_projection: bool) -> torch.Tensor:  # fmt: skip
    b, c, hh, ww = x.shape
    h = group_norm(W, f"{p}.Chain_1.GroupNorm", x, c, 1e-6)
    if linear_projection:
        h = linear(W, ops, f"{p}.Chain_1.Linear", h.flatten(2).transpose(1, 2), c, c)
    else:
        h = conv(W, ops, f"{p}.Chain_1.Conv2d", h, c, c, 1).flatten(2).transpose(1, 2)
    for i in range(depth):
        name = "CrossAttentionBlock" if depth == 1 else f"CrossAttentionBlock_{i + 1}"
        h = transformer_block(W, ops, f"{p}.Chain_2.{name}", h, ctx, c, heads)
    if linear_projection:
        h = linear(W, ops, f"{p}.Chain_3.Linear", h, c, c).transpose(1, 2).reshape(b, c, hh, ww)
    else:
        h = conv(W, ops, f"{p}.Chain_3.Conv2d", h.transpose(1, 2).reshape(b, c, hh, ww), c, c, 1)
    return x + h


class UNet:
    """A U-Net of `cfg`'s widths in the `layout` ("sd1" or "sdxl") of keys."""

    def __init__(self, cfg: dict[str, Any], layout: str) -> None:
        self.cfg, self.layout = cfg, layout
        self.attn_name = "CLIPLCrossAttention" if layout == "sd1" else "SDXLCrossAttention"
        self.linear_projection = bool(cfg.get("use_linear_projection", False))

    def time_embedding(self, W: Weights, ops: Ops, timestep: torch.Tensor, pooled: torch.Tensor | None,
                       time_ids: torch.Tensor | None) -> torch.Tensor:  # fmt: skip
        c1 = self.cfg["block_out_channels"][0]
        temb_dim = 4 * c1
        p = "TimestepEncoder.RangeEncoder" if self.layout == "sd1" else "TimestepEncoder.Sum.Chain.RangeEncoder"
        t = linear(W, ops, f"{p}.Linear_1", sinusoidal(timestep, c1), temb_dim, c1)
        t = linear(W, ops, f"{p}.Linear_2", F.silu(t), temb_dim, temb_dim)
        if self.layout == "sd1":
            return t
        assert pooled is not None and time_ids is not None
        ids = sinusoidal(time_ids, self.cfg["addition_time_embed_dim"]).flatten(1)
        e = torch.cat([pooled, ids], dim=1)
        p, width = "TimestepEncoder.Sum.TextTimeEmbedding", self.cfg["projection_class_embeddings_input_dim"]
        e = linear(W, ops, f"{p}.Linear_1", e, temb_dim, width)
        return t + linear(W, ops, f"{p}.Linear_2", F.silu(e), temb_dim, temb_dim)

    def __call__(self, W: Weights, ops: Ops, x: torch.Tensor, timestep: torch.Tensor, ctx: torch.Tensor,
                 pooled: torch.Tensor | None = None, time_ids: torch.Tensor | None = None) -> torch.Tensor:  # fmt: skip
        cfg, channels = self.cfg, self.cfg["block_out_channels"]
        levels, per_level = len(channels), cfg["layers_per_block"]
        temb = self.time_embedding(W, ops, timestep, pooled, time_ids)

        def block(p: str, h: torch.Tensor, cin: int, cout: int, level: int) -> torch.Tensor:
            h = resblock(W, ops, f"{p}.ResidualBlock", h, temb, cin, cout)
            if depth := _depth(cfg, level):
                h = spatial_transformer(W, ops, f"{p}.{self.attn_name}", h, ctx, _heads(cfg, level), depth,
                                        self.linear_projection)  # fmt: skip
            return h

        n = 1
        h = conv(W, ops, "DownBlocks.Chain_1.Conv2d", x, channels[0], cfg["in_channels"], 3, padding=1)
        skips, shapes = [h], []
        for level, cout in enumerate(channels):
            for j in range(per_level):
                n += 1
                h = block(f"DownBlocks.Chain_{n}", h, h.shape[1], cout, level)
                skips.append(h)
            if level < levels - 1:
                n += 1
                shapes.append(h.shape[2:])
                h = conv(W, ops, f"DownBlocks.Chain_{n}.Downsample.Conv2d", h, cout, cout, 3, stride=2, padding=1)
                skips.append(h)

        c = channels[-1]
        mid = "Sum.MiddleBlock" if self.layout == "sd1" else "MiddleBlock"
        h = resblock(W, ops, f"{mid}.ResidualBlock_1", h, temb, c, c)
        h = spatial_transformer(W, ops, f"{mid}.{self.attn_name}", h, ctx, _heads(cfg, levels - 1),
                                max(_depth(cfg, levels - 1), 1), self.linear_projection)  # fmt: skip
        h = resblock(W, ops, f"{mid}.ResidualBlock_2", h, temb, c, c)

        n = 0
        for level in reversed(range(levels)):
            cout = channels[level]
            for j in range(per_level + 1):
                n += 1
                p = f"UpBlocks.Chain_{n}"
                h = torch.cat([h, skips.pop()], dim=1)
                h = block(p, h, h.shape[1], cout, level)
                if level > 0 and j == per_level:
                    h = F.interpolate(h, size=tuple(shapes.pop()), mode="nearest")
                    h = conv(W, ops, f"{p}.Upsample.Conv2d", h, cout, cout, 3, padding=1)

        out = "Chain" if self.layout == "sd1" else "OutputBlock"
        h = F.silu(group_norm(W, f"{out}.GroupNorm", h, channels[0], 1e-5))
        return conv(W, ops, f"{out}.Conv2d", h, cfg["out_channels"], channels[0], 3, padding=1)
