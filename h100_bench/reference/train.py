"""Fine-tuning the U-Net on the latent-diffusion objective, in plain
PyTorch: DDPM noising at uniform timesteps (arXiv:2006.11239), the U-Net
forward and backward in float32, the gradients clipped by their global
norm, AdamW (arXiv:1711.05101) as ``torch.optim.AdamW`` computes it.

The parameters and AdamW's two moments are stored in the configuration's
dtype (each rounded to it after every update, as a model trained in that
dtype keeps them); everything else is float32. `batches` is the data the
benchmark feeds, drawn from a seed: cached latents and text embeddings,
the noise and the timesteps.
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import numpy as np
import torch

from h100_bench.reference import unet
from h100_bench.reference.diffusion import schedule
from h100_bench.reference.nn import Ops, Weights, float32_products, round_fp8


def batches(cfg: dict[str, Any], mix: dict[str, Any], seed: int, device: Any) -> Iterator[dict[str, torch.Tensor]]:
    """Batches of `mix["batch_size"]` rows that all differ: latents
    (B, 4, H/8, W/8), text embeddings (B, 77, D), DDPM noise and the
    training timesteps' indices, float32 and int64, drawn from `seed`."""
    b, (h, w) = mix["batch_size"], mix["size"]
    length, width = cfg["text_encoder"]["max_position_embeddings"], cfg["unet"]["cross_attention_dim"]
    steps = cfg["solver"]["num_train_timesteps"]
    generator = torch.Generator(device).manual_seed(seed)
    while True:
        yield {
            "latents": torch.randn((b, 4, h // 8, w // 8), generator=generator, device=device),
            "text": torch.randn((b, length, width), generator=generator, device=device),
            "noise": torch.randn((b, 4, h // 8, w // 8), generator=generator, device=device),
            "steps": torch.randint(0, steps, (b,), generator=generator, device=device),
        }


class _Leaf(Weights):
    def __init__(self, params: dict[str, torch.Tensor], fp8: bool) -> None:
        super().__init__(params, fp8=False)
        self.round = fp8

    def __call__(self, key: str, *shape: int) -> torch.Tensor:
        t = self.source[key]  # type: ignore[index]
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: {tuple(t.shape)}, the reference reads {shape}")
        return _fp8_through(t) if self.round and t.ndim >= 2 else t


def _fp8_through(t: torch.Tensor) -> torch.Tensor:
    """float8 rounding in the forward, the gradient passed straight through."""
    return t + (round_fp8(t.detach()) - t.detach())


class Finetune:
    """The first steps of fine-tuning the configuration's U-Net from
    `weights` (by the port's keys) on `mix`'s batches."""

    def __init__(self, cfg: dict[str, Any], mix: dict[str, Any], weights: dict[str, torch.Tensor], fp8: bool = False,
                 rows: slice | None = None, chunks: int = 2) -> None:  # fmt: skip
        self.cfg, self.mix, self.fp8 = cfg, mix, fp8
        self.storage = getattr(torch, cfg["dtype"])
        self.params = {k: v.detach().float().clone().requires_grad_() for k, v in weights.items()}
        self.moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in self.params.items()}
        self.model = unet.UNet(cfg["unet"], cfg["family"])
        table = schedule(cfg["solver"])
        self.alpha = torch.tensor(table, device=next(iter(weights.values())).device)
        self.rows = rows  # the rows the loss averages over (all by default)
        self.chunks = chunks

    def _store(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.storage).float()

    def loss_and_gradients(self, batch: dict[str, torch.Tensor]) -> tuple[float, dict[str, torch.Tensor]]:
        """The batch's mean squared noise error, and its gradients, in
        blocks of rows that add up to the whole batch's."""
        rows = range(batch["latents"].shape[0])[self.rows or slice(None)]
        total, ops = 0.0, Ops(self.fp8)
        W = _Leaf(self.params, self.fp8)
        for p in self.params.values():
            p.grad = None
        for block in np.array_split(np.array(rows), self.chunks):
            i = torch.as_tensor(block, device=self.alpha.device)
            t = self.cfg["solver"]["num_train_timesteps"] - 1 - batch["steps"][i]  # DDPM's timesteps run down
            a = self.alpha[t][:, None, None, None]
            x0, eps = batch["latents"][i], batch["noise"][i]
            noised = a * x0 + (1 - a * a).sqrt() * eps
            pred = self.model(W, ops, noised, t.float(), batch["text"][i])
            loss = ((pred - eps) ** 2).mean() * (len(block) / len(rows))
            loss.backward()
            total += float(loss.detach())
        return total, {k: p.grad for k, p in self.params.items()}

    @torch.no_grad()
    def adamw(self, grads: dict[str, torch.Tensor], step: int) -> None:
        o = self.mix
        beta1, beta2 = o["betas"]
        lr, wd, eps = o["learning_rate"], o["weight_decay"], o["eps"]
        c1, c2 = 1 - beta1**step, 1 - beta2**step
        for k, p in self.params.items():
            m, v = self.moments[k]
            g = grads[k]
            m.copy_(self._store(m + (1 - beta1) * (g - m)))
            v.copy_(self._store(beta2 * v + (1 - beta2) * g * g))
            decayed = self._store(p * (1 - lr * wd))
            p.copy_(self._store(decayed - (lr / c1) * m / (v.sqrt() / math.sqrt(c2) + eps)))

    def run(self, batches: Iterator[dict[str, torch.Tensor]], steps: int) -> dict[str, Any]:
        """Per step its loss; the first step's clipped gradient's norm by
        key; each parameter's change after `steps` steps, by key."""
        start = {k: p.detach().clone() for k, p in self.params.items()}
        losses, first = [], {}
        with float32_products():
            for step in range(1, steps + 1):
                loss, grads = self.loss_and_gradients(next(batches))
                norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
                scale = torch.clamp(self.mix["gradient_clipping_max_norm"] / (norm + 1e-6), max=1.0)
                grads = {k: g * scale for k, g in grads.items()}
                if step == 1:
                    first = {k: float(g.norm()) for k, g in grads.items()}
                self.adamw(grads, step)
                losses.append(loss)
        change = {k: float((p.detach() - start[k]).norm()) for k, p in self.params.items()}
        return {"losses": losses, "grad_norms": first, "change_norms": change}
