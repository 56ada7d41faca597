"""Programmatic upstream converters: DINOv2 (facebook), ELLA (tencent),
MVANet (official); counterpart of ``refiners_tpu/conversion/models/foundationals.py``.

These upstream formats need value transforms (QKV chunking, token
squeezing, GLU half-swaps) on top of key renames, so they are functions
rather than `KeyMapRecipe` tables (the reference refiners' are
``conversion/models/dinov2.py``, ``ella.py`` and ``mvanet.py``). They take
tensors or arrays and return torch tensors in torch layouts: the port's own.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import torch

from refiners_tpu_torch.conversion.utils import as_tensor


def _chunks(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """`x` split in `n` along its first dim, each piece a tensor of its own
    (safetensors refuses to save views that share memory)."""
    return [piece.clone() for piece in torch.chunk(x, n, dim=0)]


def convert_dinov2_facebook(weights: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """facebook/dinov2 checkpoint keys → reference layout."""
    src = {k: as_tensor(v) for k, v in weights.items() if k != "mask_token"}
    depth = max(int(k.split(".")[1]) for k in src if k.startswith("blocks.")) + 1

    out: dict[str, torch.Tensor] = {
        "Concatenate.ClassToken.Parameter.weight": src.pop("cls_token").squeeze(0),
        "PositionalEncoder.PositionalEmbedding.Parameter.weight": src.pop("pos_embed").squeeze(0),
        "Concatenate.PatchEncoder.Conv2d.weight": src.pop("patch_embed.proj.weight"),
        "Concatenate.PatchEncoder.Conv2d.bias": src.pop("patch_embed.proj.bias"),
        "LayerNorm.weight": src.pop("norm.weight"),
        "LayerNorm.bias": src.pop("norm.bias"),
    }
    if "register_tokens" in src:
        out["Registers.Parameter.weight"] = src.pop("register_tokens").squeeze(0)

    for i in range(depth):
        b, d = f"blocks.{i}", f"Transformer.TransformerLayer_{i + 1}"
        for leaf in ("weight", "bias"):
            out[f"{d}.Residual_1.LayerNorm.{leaf}"] = src.pop(f"{b}.norm1.{leaf}")
            out[f"{d}.Residual_1.SelfAttention.Linear.{leaf}"] = src.pop(f"{b}.attn.proj.{leaf}")
            out[f"{d}.Residual_2.LayerNorm.{leaf}"] = src.pop(f"{b}.norm2.{leaf}")
            q, k, v = _chunks(src.pop(f"{b}.attn.qkv.{leaf}"), 3)
            out[f"{d}.Residual_1.SelfAttention.Distribute.Linear_1.{leaf}"] = q
            out[f"{d}.Residual_1.SelfAttention.Distribute.Linear_2.{leaf}"] = k
            out[f"{d}.Residual_1.SelfAttention.Distribute.Linear_3.{leaf}"] = v
            # MLP: plain GeLU models use fc1/fc2; the giant uses SwiGLU w12/w3,
            # where our GLU convention swaps the two halves of w12
            if f"{b}.mlp.fc1.{leaf}" in src:
                out[f"{d}.Residual_2.FeedForward.Linear_1.{leaf}"] = src.pop(f"{b}.mlp.fc1.{leaf}")
                out[f"{d}.Residual_2.FeedForward.Linear_2.{leaf}"] = src.pop(f"{b}.mlp.fc2.{leaf}")
            else:
                w12 = src.pop(f"{b}.mlp.w12.{leaf}")
                w1, w2 = torch.chunk(w12, 2, dim=0)
                out[f"{d}.Residual_2.FeedForward.Linear_1.{leaf}"] = torch.cat([w2, w1], dim=0)
                out[f"{d}.Residual_2.FeedForward.Linear_2.{leaf}"] = src.pop(f"{b}.mlp.w3.{leaf}")
        out[f"{d}.Residual_1.LayerScale.weight"] = src.pop(f"{b}.ls1.gamma")
        out[f"{d}.Residual_2.LayerScale.weight"] = src.pop(f"{b}.ls2.gamma")
    return out


def convert_ella_tencent(weights: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """QQGYLab/ELLA checkpoint keys → reference layout."""
    out: dict[str, torch.Tensor] = {}
    for key, value in weights.items():
        arr = as_tensor(value)
        leaf = key.split(".")[-1]
        if "latents" in key:
            out["PerceiverResampler.Latents.ParameterInitialized.weight"] = arr
        elif "time_embedding" in key:
            out[key.replace("time_embedding", "TimestepEncoder.RangeEncoder").replace("linear", "Linear")] = arr
        elif "proj_in" in key:
            out[f"PerceiverResampler.Linear.{leaf}"] = arr
        elif "time_aware" in key:
            out[f"PerceiverResampler.Residual.Linear.{leaf}"] = arr
        elif "attn.in_proj" in key:
            layer = int(key.split(".")[2]) + 1
            kind = "weight" if "weight" in key else "bias"
            prefix = f"PerceiverResampler.Transformer.TransformerLayer_{layer}.Residual_1.PerceiverAttention.Attention.Distribute"
            for n, part in enumerate(_chunks(arr, 3)):
                out[f"{prefix}.Linear_{n + 1}.{kind}"] = part
        elif "attn.out_proj" in key:
            layer = int(key.split(".")[2]) + 1
            out[
                f"PerceiverResampler.Transformer.TransformerLayer_{layer}.Residual_1.PerceiverAttention.Attention.Linear.{leaf}"
            ] = arr
        elif "ln_ff" in key:
            layer = int(key.split(".")[2]) + 1
            out[
                f"PerceiverResampler.Transformer.TransformerLayer_{layer}.Residual_2.AdaLayerNorm.Parallel.Chain.Linear.{leaf}"
            ] = arr
        elif "ln_1" in key or "ln_2" in key:
            layer = int(key.split(".")[2]) + 1
            # the official ln_1 normalizes the context (our AdaLayerNorm_2),
            # ln_2 the latents (our AdaLayerNorm_1)
            n = 1 if key.split(".")[3].endswith("2") else 2
            out[
                f"PerceiverResampler.Transformer.TransformerLayer_{layer}.Residual_1.PerceiverAttention.Distribute.AdaLayerNorm_{n}.Parallel.Chain.Linear.{leaf}"
            ] = arr
        elif "mlp" in key:
            layer = int(key.split(".")[2]) + 1
            n = 1 if "c_fc" in key else 2
            out[
                f"PerceiverResampler.Transformer.TransformerLayer_{layer}.Residual_2.FeedForward.Linear_{n}.{leaf}"
            ] = arr
    return out


# -- MVANet -------------------------------------------------------------------

_MVANET_DROP = [
    # dead weights in the official checkpoint + training-only sideouts
    r"multifieldcrossatt.linear[56]",
    r"multifieldcrossatt.attention.5",
    r"dec_blk\d+\.linear[12]",
    r"dec_blk[1234]\.attention\.[4567]",
    r"sideout\d+",
]


def _mvanet_rules() -> list[tuple[str, str]]:
    """Ordered prefix-rewrite rules, applied first-match-wins per key."""
    rules: list[tuple[str, str]] = [
        ("backbone.patch_embed.proj.", "SwinTransformer.PatchEmbedding.Conv2d."),
        ("backbone.patch_embed.norm.", "SwinTransformer.PatchEmbedding.LayerNorm."),
        ("shallow.0.", "ComputeShallow.Conv2d."),
    ]

    def cbr(src: str, dst: str, shift: int = 0) -> list[tuple[str, str]]:
        return [
            (f"{src}{shift}.", f"{dst}Conv2d."),
            (f"{src}{shift + 1}.", f"{dst}BatchNorm2d."),
            (f"{src}{shift + 2}.", f"{dst}PReLU."),
        ]

    pyramid = ["Pyramid.", "Pyramid.Sum.PyramidL2.", "Pyramid.Sum.PyramidL2.Sum.PyramidL3.",
               "Pyramid.Sum.PyramidL2.Sum.PyramidL3.Sum.PyramidL4.",
               "Pyramid.Sum.PyramidL2.Sum.PyramidL3.Sum.PyramidL4.Sum.PyramidL5."]
    for n in range(5):  # output{1..5} → per-level Sum.Chain.CBR (level 5 has no Sum.Chain)
        dst = f"{pyramid[n]}{'CBR.' if n == 4 else 'Sum.Chain.CBR.'}"
        rules += cbr(f"output{n + 1}.", dst)
    for n in range(4):  # conv{1..4} → per-level CBR
        rules += cbr(f"conv{n + 1}.", f"{pyramid[n]}CBR.")

    def mclm(src: str, dst: str) -> list[tuple[str, str]]:
        pca = f"{dst}Residual.PatchwiseCrossAttention"
        r = [
            (f"{src}linear1.", f"{dst}FeedForward_1.Linear_1."),
            (f"{src}linear2.", f"{dst}FeedForward_1.Linear_2."),
            (f"{src}linear3.", f"{dst}FeedForward_2.Linear_1."),
            (f"{src}linear4.", f"{dst}FeedForward_2.Linear_2."),
            (f"{src}norm1.", f"{dst}LayerNorm_1."),
            (f"{src}norm2.", f"{dst}LayerNorm_2."),
            (f"{src}attention.0.", f"{dst}GlobalAttention.Sum.Chain.MultiheadAttention."),
        ]
        r += [(f"{src}attention.{n}.", f"{pca}.Concatenate.Chain_{n}.MultiheadAttention.") for n in (1, 2, 3, 4)]
        return r

    def mcrm(src: str, dst: str) -> list[tuple[str, str]]:
        tca = f"{dst}Parallel_3.TiledCrossAttention"
        pca = f"{tca}.Sum.Chain_2.PatchwiseCrossAttention"
        r = [
            (f"{src}linear3.", f"{tca}.FeedForward.Linear_1."),
            (f"{src}linear4.", f"{tca}.FeedForward.Linear_2."),
            (f"{src}norm1.", f"{tca}.LayerNorm_1."),
            (f"{src}norm2.", f"{tca}.LayerNorm_2."),
        ]
        r += [(f"{src}attention.{n}.", f"{pca}.Concatenate.Chain_{n + 1}.MultiheadAttention.") for n in range(4)]
        r.append((f"{src}sal_conv.", f"{dst}Parallel_2.Multiply.Chain.Conv2d."))
        return r

    rules += mclm("multifieldcrossatt.", f"{pyramid[4]}MCLM.")
    for n in range(4):
        rules += mcrm(f"dec_blk{n + 1}.", f"{pyramid[n]}MCRM.")

    rules += cbr("insmask_head.", "RearrangeMultiView.Chain.CBR_1.")
    rules += cbr("insmask_head.", "RearrangeMultiView.Chain.CBR_2.", shift=3)
    rules.append(("insmask_head.6.", "RearrangeMultiView.Chain.Conv2d."))
    rules += [
        ("upsample1.0.", "ShallowUpscaler.Sum_2.Chain_1.CBG.Conv2d."),
        ("upsample1.1.", "ShallowUpscaler.Sum_2.Chain_1.CBG.BatchNorm2d."),
        ("upsample2.0.", "ShallowUpscaler.CBG.Conv2d."),
        ("upsample2.1.", "ShallowUpscaler.CBG.BatchNorm2d."),
        ("output.0.", "Conv2d."),
    ]
    return rules


def _mvanet_swin_key(key: str) -> str | None:
    if m := re.match(r"backbone\.layers\.(\d+)\.downsample\.(.*)", key):
        s = m.group(2).replace("reduction.", "Linear.").replace("norm.", "LayerNorm.")
        return f"SwinTransformer.Chain_{int(m.group(1)) + 1}.PatchMerging.{s}"
    if m := re.match(r"backbone\.layers\.(\d+)\.blocks\.(\d+)\.(.*)", key):
        s = m.group(3)
        s = s.replace("norm1.", "Residual_1.LayerNorm.")
        s = s.replace("norm2.", "Residual_2.LayerNorm.")
        s = s.replace("attn.qkv.", "Residual_1.WindowAttention.Linear_1.")
        s = s.replace("attn.proj.", "Residual_1.WindowAttention.Linear_2.")
        s = s.replace("attn.relative_position", "Residual_1.WindowAttention.WindowSDPA.rpb.relative_position")
        s = s.replace("mlp.fc", "Residual_2.Linear_")
        return (
            f"SwinTransformer.Chain_{int(m.group(1)) + 1}"
            f".BasicLayer.SwinTransformerBlock_{int(m.group(2)) + 1}.{s}"
        )
    if m := re.match(r"backbone\.norm(\d+)\.(.*)", key):
        return f"SwinTransformer.Chain_{int(m.group(1)) + 1}.Passthrough.LayerNorm.{m.group(2)}"
    return None


def convert_mvanet_official(weights: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Official qianyu-dlut/MVANet checkpoint keys → reference layout."""
    out: dict[str, torch.Tensor] = {}
    for key, value in weights.items():
        if any(re.match(p, key) for p in _MVANET_DROP):
            continue
        new = _mvanet_swin_key(key)
        if new is None:
            new = key
            for src, dst in _mvanet_rules():
                if new.startswith(src):
                    new = dst + new[len(src):]
                    break
        out[new] = as_tensor(value)
    return out
