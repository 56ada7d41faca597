"""CLIP text encoder weight recipe (transformers → the port); counterpart of
``refiners_tpu/conversion/models/clip_text.py``.

The same rules as the JAX package's; their layout op (`op_linear`) is the
identity here, since the port keeps torch's Linear layout.
"""

from __future__ import annotations

from refiners_tpu_torch.conversion.utils import Rule, WeightRecipe, op_linear

_RES1 = "Residual_1"
_RES2 = "Residual_2"


def _layer(i: str) -> str:
    return f"TransformerLayer_{int(i) + 1}"


def hf_clip_text_recipe() -> WeightRecipe:
    """transformers `CLIPTextModel` state dict → the port's `CLIPTextEncoder` layout."""
    qkv = {"q_proj": "Linear_1", "k_proj": "Linear_2", "v_proj": "Linear_3"}
    rules: list[Rule] = [
        Rule(
            r"text_model\.embeddings\.token_embedding\.weight",
            "Sum.TokenEncoder.weight",
        ),
        Rule(
            r"text_model\.embeddings\.position_embedding\.weight",
            "Sum.PositionalEncoder.Embedding.weight",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.layer_norm1\.(weight|bias)",
            lambda m: f"{_layer(m.group(1))}.{_RES1}.LayerNorm.{m.group(2)}",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.self_attn\.(q_proj|k_proj|v_proj)\.weight",
            lambda m: f"{_layer(m.group(1))}.{_RES1}.SelfAttention.Distribute.{qkv[m.group(2)]}.weight",
            op=op_linear,
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.self_attn\.(q_proj|k_proj|v_proj)\.bias",
            lambda m: f"{_layer(m.group(1))}.{_RES1}.SelfAttention.Distribute.{qkv[m.group(2)]}.bias",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.weight",
            lambda m: f"{_layer(m.group(1))}.{_RES1}.SelfAttention.Linear.weight",
            op=op_linear,
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.bias",
            lambda m: f"{_layer(m.group(1))}.{_RES1}.SelfAttention.Linear.bias",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.layer_norm2\.(weight|bias)",
            lambda m: f"{_layer(m.group(1))}.{_RES2}.LayerNorm.{m.group(2)}",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.weight",
            lambda m: f"{_layer(m.group(1))}.{_RES2}.FeedForward.Linear_1.weight",
            op=op_linear,
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.bias",
            lambda m: f"{_layer(m.group(1))}.{_RES2}.FeedForward.Linear_1.bias",
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.weight",
            lambda m: f"{_layer(m.group(1))}.{_RES2}.FeedForward.Linear_2.weight",
            op=op_linear,
        ),
        Rule(
            r"text_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.bias",
            lambda m: f"{_layer(m.group(1))}.{_RES2}.FeedForward.Linear_2.bias",
        ),
        Rule(r"text_model\.final_layer_norm\.(weight|bias)", r"LayerNorm.\1"),
        # pooled-output projection (text_projection) and position_ids are unused here
        Rule(r"text_model\.embeddings\.position_ids", lambda m: None),
        Rule(r"text_projection\.weight", lambda m: None),
    ]
    return WeightRecipe(rules=rules, strict=True)
