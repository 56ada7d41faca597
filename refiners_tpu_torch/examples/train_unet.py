"""Finetune the SD1.5 UNet on the latent-diffusion objective, on one NVIDIA card.

    python -m refiners_tpu_torch.examples.train_unet [--weights unet.pt] [--config train.toml]

The port's counterpart of ``examples/train_unet.py``. The UNet is a
registered model of a `Trainer`; each step noises the latents with DDPM at
a random timestep and regresses the noise, and ``loss.backward()`` runs the
flash attention backward kernels at the long self-attention sites (on
tensor cores in bf16 or float16, on FFMA in float32, this config's dtype).
Torch generators seeded from ``training.seed`` replace `jax.random`: the
data, the noise and the timesteps are drawn on the training device.

``--weights`` takes a ``torch.save``d state dict of the port's `SD1UNet`
(the JAX package's key paths); without it the UNet gets seeded synthetic
weights, since real checkpoints are not in the repository. Swap the data
iterable for a real latents/caption dataset to train for real.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

import torch

from refiners_tpu_torch.fluxion.utils import synthesize_weights
from refiners_tpu_torch.foundationals.latent_diffusion import DDPM, SD1UNet
from refiners_tpu_torch.training_utils import BaseConfig, ModelConfig, Trainer, register_model

CONFIG = """
[training]
duration = "100:step"
gradient_accumulation = "4:step"
dtype = "float32"
device = "cuda"

[optimizer]
optimizer = "AdamW"
learning_rate = 1e-5

[lr_scheduler]
type = "ConstantLR"
warmup = "10:step"

[unet]
requires_grad = true
"""


class UnetConfig(BaseConfig):
    unet: ModelConfig = ModelConfig()


class UnetTrainer(Trainer[UnetConfig, dict[str, torch.Tensor]]):
    """Trains `SD1UNet` on batches of (latents (B, 4, S, S), text (B, 77, 768))."""

    def __init__(
        self,
        config: UnetConfig,
        weights: Path | None = None,
        base_channels: int = 320,
        batch_size: int = 1,
        latent_size: int = 32,
        num_batches: int = 100,
    ) -> None:
        self.weights = weights
        self.base_channels = base_channels
        self.batch_size = batch_size
        self.latent_size = latent_size
        self.num_batches = num_batches
        super().__init__(config)
        self.solver = DDPM(num_inference_steps=1000, device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(config.training.seed)

    @register_model()
    def unet(self, config: ModelConfig) -> SD1UNet:
        unet = SD1UNet(in_channels=4, base_channels=self.base_channels, device=self.device)
        if self.weights is not None:
            unet.load_state_dict(torch.load(self.weights, map_location=self.device, weights_only=True))
        else:
            synthesize_weights(unet, seed=self.config.training.seed)
        return unet

    def create_data_iterable(self) -> list[dict[str, torch.Tensor]]:
        gen = torch.Generator(self.device).manual_seed(self.config.training.seed + 1)
        b, s = self.batch_size, self.latent_size
        return [
            {
                "latents": torch.randn((b, 4, s, s), generator=gen, device=self.device),
                "text": torch.randn((b, 77, 768), generator=gen, device=self.device),
            }
            for _ in range(self.num_batches)
        ]

    def compute_loss(self, batch: dict[str, Any]) -> torch.Tensor:
        latents = batch["latents"].to(self.dtype)
        # drawn for the whole batch, then this rank's rows (under [training.mesh]): the same draws on any mesh
        shape = (self.batch_size, *latents.shape[1:])
        noise = torch.randn(shape, generator=self.generator, device=self.device).to(self.dtype)
        steps = torch.randint(
            0, self.solver.num_inference_steps, (self.batch_size,), generator=self.generator, device=self.device
        )
        noise, steps = self.shard_batch((noise, steps))
        noised = self.solver.add_noise(latents, noise, steps)
        self.unet.set_timestep(self.solver.timesteps[steps])
        self.unet.set_clip_text_embedding(batch["text"].to(self.dtype))
        prediction = self.unet(noised)
        return ((prediction.float() - noise.float()) ** 2).mean()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", type=Path, default=None, help="torch.save'd SD1UNet state dict (default: synthetic)")
    p.add_argument("--config", type=Path, default=None, help="TOML config (default: the one in this file)")
    args = p.parse_args()
    config = UnetConfig.load_from_toml(args.config) if args.config else UnetConfig.load_from_toml_string(CONFIG)
    UnetTrainer(config, weights=args.weights).train()


if __name__ == "__main__":
    main()
