"""Fine-tuning steps through the port's `Trainer`: the configuration's U-Net
registered as a model of a `Trainer` subclass, ``[training] jit_step``
on (loss and backward as one CUDA graph), the optimizer, the clipping and
the learning rate as the mix states them. Each step takes the next batch
of the benchmark's feed (`reference.train.batches`): cached latents and
text embeddings, DDPM noise and uniform timesteps, every row new.

Set-up builds the trainer and drives it through the mix's first steps
(``warmup_steps``: the first captures the program, the rest replay) on the
window's own call and feed, reading the losses, the first gradient as
AdamW holds it after one step (its first moment over 1 - beta1) and each
parameter's change after them. The window then goes on with the same
trainer. Afterwards the float32 reference follows the same first steps
from the same weights and batches, and the readings are compared leaf by
leaf.
"""

# no `from __future__ import annotations`: the config class below is read by its evaluated annotations
import statistics
import time
from typing import Any

import torch

from h100_bench import driver, models
from h100_bench.bench import Cell, Run
from h100_bench.reference.diffusion import model_spec
from h100_bench.reference.train import Finetune, batches
from h100_bench.weights import derive, make


def _unet_weights(cfg: dict[str, Any], seed: int, device: Any, dtype: Any) -> dict[str, torch.Tensor]:
    shapes = {k[len("unet.") :]: s for k, s in model_spec(cfg).items() if k.startswith("unet.")}
    return make({f"unet.{k}": s for k, s in shapes.items()}, seed, device, dtype)


def _config(mix: dict[str, Any], cfg: dict[str, Any], seed: int, device: torch.device) -> str:
    beta1, beta2 = mix["betas"]
    return f"""
[training]
duration = "1000000000:step"
gradient_accumulation = "1:step"
gradient_clipping_max_norm = {mix["gradient_clipping_max_norm"]}
dtype = "{cfg["dtype"]}"
device = "{device}"
seed = {derive(seed, "trainer") % 2**31}
jit_step = true

[optimizer]
optimizer = "{mix["optimizer"]}"
learning_rate = {mix["learning_rate"]}
betas = [{beta1}, {beta2}]
eps = {mix["eps"]}
weight_decay = {mix["weight_decay"]}

[lr_scheduler]
type = "ConstantLR"

[unet]
requires_grad = true
"""


def trainer(cell: Cell, seed: int, device: torch.device) -> Any:
    """The port's `Trainer` of the cell's U-Net, weights drawn from `seed`."""
    from refiners_tpu_torch.foundationals.latent_diffusion import DDPM
    from refiners_tpu_torch.training_utils import BaseConfig, ModelConfig, Trainer, register_model

    cfg = cell.cfg

    class UNetConfig(BaseConfig):
        unet: ModelConfig = ModelConfig()

    class UNetTrainer(Trainer[UNetConfig, dict[str, torch.Tensor]]):
        @register_model()
        def unet(self, config: ModelConfig) -> Any:
            model = models.unet(cfg, self.device, self.dtype)
            weights = _unet_weights(cfg, seed, self.device, self.dtype)
            models.load({"unet": model}, weights)
            return model

        def create_data_iterable(self) -> list[dict[str, torch.Tensor]]:
            return []  # the benchmark feeds `step` itself

        def compute_loss(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
            latents, noise = batch["latents"].to(self.dtype), batch["noise"].to(self.dtype)
            noised = self.solver.add_noise(latents, noise, batch["steps"])
            self.unet.set_timestep(self.solver.timesteps[batch["steps"]])
            self.unet.set_clip_text_embedding(batch["text"].to(self.dtype))
            prediction = self.unet(noised)
            return ((prediction.float() - noise.float()) ** 2).mean()

    config = UNetConfig.load_from_toml_string(_config(cell.mix, cfg, seed, device))
    t = UNetTrainer(config)
    t.solver = DDPM(num_inference_steps=cfg["solver"]["num_train_timesteps"], device=device)
    return t


class Driver(driver.Driver):
    def __init__(self, cell: Cell, seed: int, device: torch.device) -> None:
        super().__init__(cell, seed, device)
        self.readings: dict[str, Any] = {}

    def setup(self) -> None:
        self.trainer = trainer(self.cell, self.seed, self.device)
        self.feed = batches(self.cell.cfg, self.cell.mix, derive(self.seed, "batches"), self.device)
        self.time_programs()
        self.span(type(self.trainer), "backward", "Trainer.backward")
        self.readings = self.first_steps(self.cell.mix["warmup_steps"])
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def first_steps(self, n: int) -> dict[str, Any]:
        """Drive the trainer through its first `n` steps and read them."""
        t = self.trainer
        losses, first = [], {}
        for step in range(1, n + 1):
            self.step()
            losses.append(float(t.loss))
            if step == 1:
                optimizer = t.models["unet"].optimizer
                beta1 = optimizer.param_groups[0]["betas"][0]
                first = {k: float(optimizer.state[p]["exp_avg"].float().norm()) / (1 - beta1)
                         for k, p in t.unet.named_parameters()}  # fmt: skip
        start = _unet_weights(self.cell.cfg, self.seed, self.device, t.dtype)
        change = {k: float((p.detach().float() - start[f"unet.{k}"].float()).norm()) for k, p in t.unet.named_parameters()}
        return {"losses": losses, "grad_norms": first, "change_norms": change}

    def step(self) -> torch.Tensor:
        with self.annotate("Trainer.step"):
            self.trainer.step(next(self.feed))
        return self.trainer.loss

    def window(self, run: Run, seconds: float) -> None:
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.host_s, steps = 0.0, 0
        finite = torch.zeros((), device=self.device)
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            finite += torch.isfinite(self.step()).float()
            steps += 1
        self.sync()
        run.window_s = time.perf_counter() - start
        run.calls = run.attempted = steps
        run.failed = steps - int(finite)
        run.items = steps * self.cell.mix["batch_size"]
        run.program_host_s = self.host_s

    def stretch(self, annotate: Any) -> int:
        n = self.cell.mix["profiled_steps"]
        self.profiled(annotate, n, self.step)
        return n * self.cell.mix["batch_size"]

    def free(self) -> None:
        del self.trainer, self.feed
        self.release()

    def reference(self, fp8: bool = False, rows: slice | None = None) -> dict[str, Any]:
        """The reference's readings of the same first steps, from the same weights and batches."""
        cfg, mix = self.cell.cfg, self.cell.mix
        weights = _unet_weights(cfg, self.seed, self.device, getattr(torch, cfg["dtype"]))
        reference = Finetune(cfg, mix, {k[len("unet.") :]: v for k, v in weights.items()}, fp8=fp8, rows=rows)
        del weights
        feed = batches(cfg, mix, derive(self.seed, "batches"), self.device)
        return reference.run(feed, mix["warmup_steps"])

    def check(self) -> dict[str, float]:
        return gaps(self.readings, self.reference())


def gaps(readings: dict[str, Any], reference: dict[str, Any]) -> dict[str, float]:
    """The widest relative gap of the steps' losses; and, leaf by leaf, of
    the first gradient's norm and of the change after the first steps,
    each against the larger of the reference's norm of that leaf and of the
    median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's (rounding noise that AdamW turns into a full step) are
    left out of both."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(readings["losses"], reference["losses"]))
    grads, change = reference["grad_norms"], reference["change_norms"]
    median_grad, median_change = statistics.median(grads.values()), statistics.median(change.values())
    kept = [k for k in grads if grads[k] >= 1e-3 * median_grad]
    grad = max(abs(readings["grad_norms"][k] - grads[k]) / max(grads[k], median_grad) for k in kept)
    moved = max(abs(readings["change_norms"][k] - change[k]) / max(change[k], median_change, 1e-30) for k in kept)
    return {"loss_rel": loss, "grad_gap": grad, "change_gap": moved}
