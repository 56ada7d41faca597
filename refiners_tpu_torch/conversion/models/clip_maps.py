"""Upstream key maps for CLIP text / image encoders; counterpart of
``refiners_tpu/conversion/models/clip_maps.py``.

The reference refiners' tables are ``conversion/models/clip_text_sd15.py``
(transformers layout, and original-LDM) and ``clip_image_sd21.py``
(the transformers vision tower, ViT-H for IP-Adapter / unCLIP).
"""

from __future__ import annotations


def _text_layer(src: str, dst: str) -> dict[str, str]:
    return {
        f"{src}.layer_norm1": f"{dst}.Residual_1.LayerNorm",
        f"{src}.self_attn.q_proj": f"{dst}.Residual_1.SelfAttention.Distribute.Linear_1",
        f"{src}.self_attn.k_proj": f"{dst}.Residual_1.SelfAttention.Distribute.Linear_2",
        f"{src}.self_attn.v_proj": f"{dst}.Residual_1.SelfAttention.Distribute.Linear_3",
        f"{src}.self_attn.out_proj": f"{dst}.Residual_1.SelfAttention.Linear",
        f"{src}.layer_norm2": f"{dst}.Residual_2.LayerNorm",
        f"{src}.mlp.fc1": f"{dst}.Residual_2.FeedForward.Linear_1",
        f"{src}.mlp.fc2": f"{dst}.Residual_2.FeedForward.Linear_2",
    }


def clip_text_diffusers_key_map(num_layers: int = 12) -> dict[str, str]:
    """transformers CLIPTextModel keys → reference layout (clip_text_sd15.py:5)."""
    m = {
        "text_model.embeddings.token_embedding": "Sum.TokenEncoder",
        "text_model.embeddings.position_embedding": "Sum.PositionalEncoder.Embedding",
        "text_model.final_layer_norm": "LayerNorm",
        "text_projection": "Linear",
    }
    for n in range(num_layers):
        m |= _text_layer(f"text_model.encoder.layers.{n}", f"TransformerLayer_{n + 1}")
    return m


def clip_text_civitai_key_map(num_layers: int = 12) -> dict[str, str]:
    """Original-LDM CLIP keys ("cond_stage_model.transformer.text_model.") →
    reference layout (clip_text_sd15.py:111)."""
    m = {
        "embeddings.token_embedding": "Sum.TokenEncoder",
        "embeddings.position_embedding": "Sum.PositionalEncoder.Embedding",
        "final_layer_norm": "LayerNorm",
    }
    for n in range(num_layers):
        m |= _text_layer(f"encoder.layers.{n}", f"TransformerLayer_{n + 1}")
    return m


def clip_image_diffusers_key_map(num_layers: int = 32) -> dict[str, str]:
    """transformers CLIPVisionModelWithProjection keys → reference layout
    (clip_image_sd21.py:5)."""
    m = {
        "vision_model.embeddings.patch_embedding": "ViTEmbeddings.Concatenate.Chain.PatchEncoder.Conv2d",
        "vision_model.embeddings.position_embedding": "ViTEmbeddings.Residual.PositionalEncoder.Embedding",
        "vision_model.embeddings.class_embedding": "ViTEmbeddings.Concatenate.ClassToken.Parameter.weight",
        "vision_model.pre_layrnorm": "LayerNorm_1",
        "vision_model.post_layernorm": "LayerNorm_2",
        "visual_projection": "Linear",
    }
    for n in range(num_layers):
        m |= _text_layer(f"vision_model.encoder.layers.{n}", f"Chain.TransformerLayer_{n + 1}")
    return m


def clip_image_reshapes(embedding_dim: int = 1280) -> dict[str, tuple[int, ...]]:
    return {"ViTEmbeddings.Concatenate.ClassToken.Parameter.weight": (1, embedding_dim)}
