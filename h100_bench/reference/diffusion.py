"""Text to image, and the training objective, in plain PyTorch: the noise
schedule (DDPM's, arXiv:2006.11239), DDIM's deterministic update
(arXiv:2010.02502) under classifier-free guidance (arXiv:2207.12598),
the text encoders, the U-Net and the decoder of this folder.

The schedule is the published ``scaled_linear`` one: betas evenly spaced
in square root between ``beta_start`` and ``beta_end`` (float32, as the
port and diffusers make them); DDIM's timesteps are ``leading`` with
``steps_offset``, and its last step goes to the first training timestep's
signal level, as the port's does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from h100_bench.reference import clip, unet, vae
from h100_bench.reference.nn import Ops, Weights
from h100_bench.reference.tokenizer import Tokenizer


def schedule(solver: dict[str, Any]) -> np.ndarray:
    """sqrt(ᾱ_t), t = 0 … num_train_timesteps - 1, float32."""
    n = solver["num_train_timesteps"]
    betas = np.linspace(np.float32(solver["beta_start"]) ** np.float32(0.5), np.float32(solver["beta_end"]) ** np.float32(0.5),
                        n, dtype=np.float32) ** np.float32(2)  # fmt: skip
    return np.sqrt(np.cumprod(np.float32(1) - betas))


def ddim_timesteps(solver: dict[str, Any]) -> list[int]:
    steps = solver["num_inference_steps"]
    ratio = solver["num_train_timesteps"] // steps
    return [i * ratio + solver["steps_offset"] for i in range(steps)][::-1]


class TextToImage:
    """One configuration's text-to-image, in float32 or (`fp8`) with every
    product's inputs rounded to float8. `weights` are the model's tensors by
    the port's keys (UNet under ``unet.``, text encoder under ``text.``,
    autoencoder under ``vae.``)."""

    def __init__(self, cfg: dict[str, Any], weights: dict[str, torch.Tensor], fp8: bool = False) -> None:
        self.cfg = cfg
        self.ops = Ops(fp8)
        self.weights = {part: Weights(_part(weights, part), fp8=fp8) for part in ("unet", "text", "vae")}
        self.unet = unet.UNet(cfg["unet"], cfg["family"])
        self.tokenizer = Tokenizer()
        self.table = schedule(cfg["solver"])
        self.timesteps = ddim_timesteps(cfg["solver"])

    def encode_text(self, prompt: str, negative: str, device: torch.device) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The (2, 77, D) [negative, prompt] embedding, and SDXL's pooled one."""
        W, cfg = self.weights["text"], self.cfg
        if cfg["family"] == "sd1":
            tokens = torch.tensor([self.tokenizer(negative), self.tokenizer(prompt)], device=device)
            return clip.clip_l(W, self.ops, tokens, cfg["text_encoder"]), None
        tokens_l = torch.tensor([self.tokenizer(negative), self.tokenizer(prompt)], device=device)
        tokens_g = torch.tensor([self.tokenizer(negative, pad=0), self.tokenizer(prompt, pad=0)], device=device)
        return clip.sdxl_text(W, self.ops, tokens_l, tokens_g, cfg["text_encoder"], cfg["text_encoder_2"])

    def noise_prediction(self, x: torch.Tensor, t: int, ctx: torch.Tensor, pooled: torch.Tensor | None,
                         scale: float) -> torch.Tensor:  # fmt: skip
        timestep = torch.tensor([float(t)], device=x.device)
        time_ids = None
        if pooled is not None:  # SDXL's size and crop conditioning, as the configuration states it
            time_ids = torch.tensor([self.cfg["time_ids"]] * 2, device=x.device, dtype=torch.float32)
        both = self.unet(self.weights["unet"], self.ops, torch.cat([x, x]), timestep, ctx, pooled, time_ids)
        uncond, cond = both.chunk(2)
        return uncond + scale * (cond - uncond)

    @torch.no_grad()
    def __call__(self, prompt: str, negative: str, noise: torch.Tensor, scale: float) -> torch.Tensor:
        """The final latents of 30 DDIM steps from float32 `noise` (1, 4, h, w)."""
        ctx, pooled = self.encode_text(prompt, negative, noise.device)
        x = noise.float()
        for i, t in enumerate(self.timesteps):
            eps = self.noise_prediction(x, t, ctx, pooled, scale)
            a = float(self.table[t])
            a_prev = float(self.table[self.timesteps[i + 1]] if i + 1 < len(self.timesteps) else self.table[0])
            x0 = (x - (1 - a * a) ** 0.5 * eps) / a
            x = a_prev * x0 + ((1 - a_prev * a_prev) ** 0.5 * eps if i + 1 < len(self.timesteps) else 0)
        return x

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents → the image in [0, 1]."""
        image = vae.decode(self.weights["vae"], self.ops, z, self.cfg["vae"]["scaling_factor"])
        return ((image + 1) / 2).clamp(0, 1)


def _part(weights: dict[str, torch.Tensor], part: str) -> dict[str, torch.Tensor]:
    prefix = f"{part}."
    return {k[len(prefix) :]: v for k, v in weights.items() if k.startswith(prefix)}


def model_spec(cfg: dict[str, Any]) -> dict[str, tuple[int, ...]]:
    """Every key and shape of the configuration's model (UNet, text encoder,
    autoencoder), prefixed ``unet.``, ``text.``, ``vae.``, in a fixed order."""
    shapes: dict[str, tuple[int, ...]] = {}
    tokens = torch.zeros((1, cfg["text_encoder"]["max_position_embeddings"]), dtype=torch.int64, device="meta")
    latents = torch.empty((2, cfg["unet"]["in_channels"], 16, 16), device="meta")
    W, ops = Weights(), Ops()
    if cfg["family"] == "sd1":
        ctx = clip.clip_l(W, ops, tokens, cfg["text_encoder"])
        pooled = time_ids = None
    else:
        ctx, pooled = clip.sdxl_text(W, ops, tokens, tokens, cfg["text_encoder"], cfg["text_encoder_2"])
        time_ids = torch.empty((1, 6), device="meta")
    shapes.update((f"text.{k}", s) for k, s in W.shapes.items())
    W = Weights()
    unet.UNet(cfg["unet"], cfg["family"])(W, ops, latents, torch.empty((1,), device="meta"), ctx, pooled, time_ids)
    shapes.update((f"unet.{k}", s) for k, s in W.shapes.items())
    W = Weights()
    z = vae.encode(W, ops, torch.empty((1, 3, 64, 64), device="meta"), 1.0)
    vae.decode(W, ops, z, 1.0)
    shapes.update((f"vae.{k}", s) for k, s in W.shapes.items())
    return shapes
