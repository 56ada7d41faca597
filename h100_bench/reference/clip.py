"""CLIP's text encoders (arXiv:2103.00020) in plain PyTorch, read by the
port's state-dict keys: CLIP-L for SD1.5 (its last layer's normalized
output), and SDXL's pair (CLIP-L's and OpenCLIP-G's penultimate hidden
states side by side, and G's last layer, normalized and projected, at the
end-of-text token as the pooled embedding).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from h100_bench.reference.nn import Ops, Weights, layer_norm, linear

END_OF_TEXT = 49407


def embed(W: Weights, p: str, tokens: torch.Tensor, dim: int, vocabulary: int, length: int) -> torch.Tensor:
    positions = W(f"{p}.Sum.PositionalEncoder.Embedding.weight", length, dim)[: tokens.shape[1]]
    return W(f"{p}.Sum.TokenEncoder.weight", vocabulary, dim)[tokens] + positions


def layer(W: Weights, ops: Ops, p: str, x: torch.Tensor, dim: int, heads: int, ff: int, quick_gelu: bool) -> torch.Tensor:
    """Pre-norm causal self-attention, then Linear → GeLU → Linear."""
    h = layer_norm(W, f"{p}.Residual_1.LayerNorm", x, dim)
    a = f"{p}.Residual_1.SelfAttention"
    q, k, v = (linear(W, ops, f"{a}.Distribute.Linear_{i}", h, dim, dim) for i in (1, 2, 3))
    x = x + linear(W, ops, f"{a}.Linear", ops.attention(q, k, v, heads, causal=True), dim, dim)
    h = layer_norm(W, f"{p}.Residual_2.LayerNorm", x, dim)
    h = linear(W, ops, f"{p}.Residual_2.FeedForward.Linear_1", h, ff, dim)
    h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
    return x + linear(W, ops, f"{p}.Residual_2.FeedForward.Linear_2", h, dim, ff)


def _settings(cfg: dict[str, Any]) -> tuple[int, int, int, int, bool, int, int]:
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"], cfg["num_hidden_layers"],
            cfg["hidden_act"] == "quick_gelu", cfg["vocab_size"], cfg["max_position_embeddings"])  # fmt: skip


def clip_l(W: Weights, ops: Ops, tokens: torch.Tensor, cfg: dict[str, Any]) -> torch.Tensor:
    """SD1.5's text embedding: every layer, then the final LayerNorm (keys at the root)."""
    dim, heads, ff, n, quick, vocabulary, length = _settings(cfg)
    positions = W("Sum.PositionalEncoder.Embedding.weight", length, dim)[: tokens.shape[1]]
    x = W("Sum.TokenEncoder.weight", vocabulary, dim)[tokens] + positions
    for i in range(n):
        x = layer(W, ops, f"TransformerLayer_{i + 1}", x, dim, heads, ff, quick)
    return layer_norm(W, "LayerNorm", x, dim)


def sdxl_text(W: Weights, ops: Ops, tokens_l: torch.Tensor, tokens_g: torch.Tensor, cfg_l: dict[str, Any],
              cfg_g: dict[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:  # fmt: skip
    """SDXL's (B, 77, 768 + 1280) text embedding and (B, 1280) pooled embedding."""
    dim, heads, ff, n, quick, vocabulary, length = _settings(cfg_l)
    p = "Parallel.CLIPTextEncoderL"
    x = embed(W, p, tokens_l, dim, vocabulary, length)
    for i in range(n - 1):  # the penultimate hidden state
        x = layer(W, ops, f"{p}.TransformerLayer_{i + 1}", x, dim, heads, ff, quick)
    hidden_l = x

    dim, heads, ff, n, quick, vocabulary, length = _settings(cfg_g)
    p = "Parallel.TextEncoderWithPooling"
    x = embed(W, f"{p}.CLIPTextEncoderG", tokens_g, dim, vocabulary, length)
    for i in range(n - 1):
        x = layer(W, ops, f"{p}.CLIPTextEncoderG.TransformerLayer_{i + 1}", x, dim, heads, ff, quick)
    hidden_g = x
    last = f"{p}.Parallel.Chain.CLIPTextEncoderG"
    x = layer_norm(W, f"{last}.LayerNorm", layer(W, ops, f"{last}.TransformerLayer", x, dim, heads, ff, quick), dim)
    x = linear(W, ops, f"{p}.Parallel.Chain.Linear", x, cfg_g["projection_dim"], dim, bias=False)
    end = (tokens_g == END_OF_TEXT).int().argmax(dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), end]
    return torch.cat([hidden_l, hidden_g], dim=-1), pooled
