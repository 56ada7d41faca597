"""The port's models built to a configuration's widths and loaded with the
benchmark's weights (``load_state_dict(strict=True)``: a key or a shape
that the reference does not read fails the run)."""

from __future__ import annotations

from typing import Any

import torch


def _text_encoder(cls: type, cfg: dict[str, Any], device: Any, dtype: Any, pad: int | None = None) -> Any:
    """A CLIP text encoder of `cfg`'s widths as an instance of the port's
    published class `cls` (its name is part of SDXL's keys)."""
    from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoder
    from refiners_tpu_torch.foundationals.clip.tokenizer import CLIPTokenizer

    encoder = cls.__new__(cls)
    CLIPTextEncoder.__init__(
        encoder,
        embedding_dim=cfg["hidden_size"],
        max_sequence_length=cfg["max_position_embeddings"],
        vocabulary_size=cfg["vocab_size"],
        num_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        feedforward_dim=cfg["intermediate_size"],
        use_quick_gelu=cfg["hidden_act"] == "quick_gelu",
        tokenizer=CLIPTokenizer(pad_token_id=pad) if pad is not None else None,
        device=device,
        dtype=dtype,
    )
    return encoder


def solver(cfg: dict[str, Any], device: Any) -> Any:
    """The configuration's DDIM."""
    from refiners_tpu_torch.foundationals.latent_diffusion.solvers import DDIM
    from refiners_tpu_torch.foundationals.latent_diffusion.solvers.solver import NoiseSchedule, SolverParams, TimestepSpacing

    s = cfg["solver"]
    if s["name"] != "DDIM" or s["beta_schedule"] != "scaled_linear":
        raise ValueError(f"unsupported solver {s}")
    params = SolverParams(
        num_train_timesteps=s["num_train_timesteps"],
        timesteps_spacing=TimestepSpacing(s["timestep_spacing"]),
        timesteps_offset=s["steps_offset"],
        initial_diffusion_rate=s["beta_start"],
        final_diffusion_rate=s["beta_end"],
        noise_schedule=NoiseSchedule.QUADRATIC,
    )
    return DDIM(num_inference_steps=s["num_inference_steps"], params=params, device=device)


def unet(cfg: dict[str, Any], device: Any, dtype: Any) -> Any:
    from refiners_tpu_torch.foundationals.latent_diffusion import SD1UNet, SDXLUNet

    u = cfg["unet"]
    cls = SD1UNet if cfg["family"] == "sd1" else SDXLUNet
    return cls(in_channels=u["in_channels"], base_channels=u["block_out_channels"][0], device=device, dtype=dtype)


def latent_diffusion(cfg: dict[str, Any], device: Any, dtype: Any) -> Any:
    """StableDiffusion_1 or StableDiffusion_XL of `cfg`'s widths."""
    from refiners_tpu_torch.foundationals.clip.text_encoder import CLIPTextEncoderG, CLIPTextEncoderL
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_1.model import SD1Autoencoder, StableDiffusion_1
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import SDXLAutoencoder, StableDiffusion_XL
    from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.text_encoder import DoubleTextEncoder

    if cfg["family"] == "sd1":
        return StableDiffusion_1(
            unet=unet(cfg, device, dtype),
            lda=SD1Autoencoder(device=device, dtype=dtype),
            clip_text_encoder=_text_encoder(CLIPTextEncoderL, cfg["text_encoder"], device, dtype),
            solver=solver(cfg, device),
            device=device,
            dtype=dtype,
        )
    text = DoubleTextEncoder(
        text_encoder_l=_text_encoder(CLIPTextEncoderL, cfg["text_encoder"], device, dtype),
        text_encoder_g=_text_encoder(CLIPTextEncoderG, cfg["text_encoder_2"], device, dtype, pad=0),
        device=device,
        dtype=dtype,
    )
    return StableDiffusion_XL(unet=unet(cfg, device, dtype), lda=SDXLAutoencoder(device=device, dtype=dtype),
                              clip_text_encoder=text, solver=solver(cfg, device), device=device, dtype=dtype)  # fmt: skip


def load(parts: dict[str, torch.nn.Module], weights: dict[str, torch.Tensor]) -> None:
    """Load each part (``unet``, ``text``, ``vae``) from its keys in `weights`, strictly."""
    for part, module in parts.items():
        prefix = f"{part}."
        module.load_state_dict({k[len(prefix) :]: v for k, v in weights.items() if k.startswith(prefix)}, strict=True)


def parts(sd: Any) -> dict[str, torch.nn.Module]:
    return {"unet": sd.unet, "text": sd.clip_text_encoder, "vae": sd.lda}
