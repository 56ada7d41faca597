"""Closed-loop serving through the port's `TextToImage`: one client sends a
request as the last one returns. Each request draws a prompt and a negative
prompt from the mix's list and a noise seed of its own, all from the run's
seed; every request is of the mix's one size, so a seed changes the
prompts and the noise, never the work.

The window runs whole requests: it starts them until ``--seconds`` have
passed and counts the last one to its end. Afterwards a sample of the
window's requests, drawn from the seed, is served again by the plain
float32 reference on the same prompts and noise, and the latents and images
are compared.
"""

from __future__ import annotations

import random
import time
from typing import Any

import numpy as np
import torch

from h100_bench import driver, models
from h100_bench.bench import Cell, Run
from h100_bench.reference.diffusion import TextToImage as ReferenceTextToImage
from h100_bench.reference.diffusion import model_spec
from h100_bench.reference.nn import float32_products
from h100_bench.weights import derive, make


def prompts(cell: Cell) -> tuple[list[str], list[str]]:
    lines = (cell.bench / "traffic" / cell.mix["prompts"]).read_text().splitlines()
    positive = [l[2:] for l in lines if l.startswith("+ ")]
    negative = [l[2:] for l in lines if l.startswith("- ")]
    return positive, negative


class Driver(driver.Driver):
    def __init__(self, cell: Cell, seed: int, device: torch.device) -> None:
        super().__init__(cell, seed, device)
        self.dtype = getattr(torch, cell.cfg["dtype"])
        self.positive, self.negative = prompts(cell)
        self.rng = random.Random(derive(seed, "requests"))
        self.images: list[np.ndarray] = []
        self.requests: list[tuple[str, str, int]] = []
        self.latents: list[torch.Tensor] = []  # the denoising loop's outputs, one a request

    def next_request(self) -> tuple[str, str, int]:
        return (self.rng.choice(self.positive), self.rng.choice(self.negative), self.rng.getrandbits(62))

    # -- the program ---------------------------------------------------------

    def setup(self) -> None:
        from refiners_tpu_torch import pipelines

        cfg, mix = self.cell.cfg, self.cell.mix
        weights = make(model_spec(cfg), self.seed, self.device, self.dtype)
        self.sd = models.latent_diffusion(cfg, self.device, self.dtype)
        models.load(models.parts(self.sd), weights)
        del weights
        for adapter, params in self.cell.adapters():
            adapter.attach(self.sd, cfg, params, self.seed, self.device)
        self.pipe = pipelines.TextToImage(self.sd, size=tuple(mix["size"]), condition_scale=cfg["guidance_scale"],
                                          num_images=mix["num_images"])  # fmt: skip
        self.time_programs(self._keep_latents)
        self.span(type(self.sd), "compute_clip_text_embedding", "compute_clip_text_embedding")
        self.span(pipelines, "tensor_to_images", "tensor_to_images")
        for _ in range(mix["warmup_requests"]):  # the first call of each program captures it, the next replays
            self.serve(*self.next_request())
        self.rng = random.Random(derive(self.seed, "window"))
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reseed(self, seed: int) -> None:
        """New weights drawn from `seed`, copied into the loaded model's
        tensors, so that its programs replay (adapters are attached anew,
        and their programs captured again); new requests."""
        self.seed = seed
        adapters = self.cell.adapters()
        for adapter, params in adapters:
            adapter.detach(self.sd, params)
        models.load(models.parts(self.sd), make(model_spec(self.cell.cfg), seed, self.device, self.dtype))
        for adapter, params in adapters:
            adapter.attach(self.sd, self.cell.cfg, params, seed, self.device)
        self.rng = random.Random(derive(seed, "window"))
        for _ in range(self.cell.mix["warmup_requests"] if adapters else 0):  # new adapters: new programs
            self.serve(*self.next_request())

    def _keep_latents(self, program: Any, out: Any) -> None:
        if program.name == "TextToImage.diffuse":
            self.latents.append(out)

    def serve(self, prompt: str, negative: str, seed: int) -> Any:
        with self.annotate("TextToImage.__call__"):
            return self.pipe(prompt, negative_prompt=negative, seed=seed)

    # -- the window ----------------------------------------------------------

    def window(self, run: Run, seconds: float) -> None:
        self.latents.clear()
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.host_s = 0.0
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            request = self.next_request()
            sent = time.perf_counter()
            image = self.serve(*request)  # a PIL image: the decode has reached the host
            end = time.perf_counter()
            run.latencies.append(end - sent)
            self.requests.append(request)
            self.images.append(np.asarray(image))
        run.window_s, run.calls = end - start, len(self.requests)
        run.items = run.attempted = run.calls * self.cell.mix["num_images"]
        run.program_host_s = self.host_s
        self.window_latents = self.latents[:]

    def stretch(self, annotate: Any) -> int:
        """Whole requests under the profiler, after the window."""
        n = self.cell.mix["profiled_requests"]
        self.profiled(annotate, n, lambda: self.serve(*self.next_request()))
        return n * self.cell.mix["num_images"]

    def free(self) -> None:
        del self.pipe, self.sd
        self.latents.clear()
        self.release()

    # -- the comparison ------------------------------------------------------

    def reference(self, indices: list[int], fp8: bool = False, pipeline: bool = True) -> list[dict[str, torch.Tensor]]:
        """For each of the window's requests `indices`, from weights drawn
        again from the seed: the reference's final latents from the same
        prompts and noise (with `pipeline`), and its decode of the
        program's own latents, in [0, 1]."""
        cfg, (h, w) = self.cell.cfg, self.cell.mix["size"]
        weights = make(model_spec(cfg), self.seed, self.device, self.dtype)
        for adapter, params in self.cell.adapters():
            weights = adapter.reference_weights(weights, cfg, params, self.seed, self.device)
        reference = ReferenceTextToImage(cfg, weights, fp8=fp8)
        out = []
        with float32_products():
            for i in indices:
                entry = {"decoded": reference.decode(self.window_latents[i].float())}
                if pipeline:
                    prompt, negative, seed = self.requests[i]
                    generator = torch.Generator(self.device).manual_seed(seed)
                    noise = torch.randn((1, 4, h // 8, w // 8), generator=generator, device=self.device)
                    entry["latents"] = reference(prompt, negative, noise, cfg["guidance_scale"])
                out.append(entry)
        return out

    def sample(self) -> list[int]:
        """The window's requests that the comparison serves again, drawn from the seed."""
        k = min(self.cell.mix["checked_requests"], len(self.requests))
        return random.Random(derive(self.seed, "check")).sample(range(len(self.requests)), k)

    def check(self) -> dict[str, float]:
        indices = self.sample()
        served = [{"latents": self.window_latents[i], "decoded": self.images[i]} for i in indices]
        return gaps(served, self.reference(indices), self.device)


def gaps(served: list[dict[str, Any]], reference: list[dict[str, torch.Tensor]], device: torch.device) -> dict[str, float]:
    """`latent_rel`: the relative L2 gap of the final latents, the mean over
    the sampled requests (30 steps amplify rounding by a factor that swings
    from seed to seed; the mean steadies it). `decode_rms`: the widest RMS
    gap, over pixels in [0, 1], of the decode of the program's own latents,
    the decoder's stage on its own. A served image is uint8 (H, W, 3), or a
    float (1, 3, H, W) tensor in [0, 1] that is rounded to 8 bits as the
    port's are."""
    latent_rel, decode_rms = [], 0.0
    for mine, ref in zip(served, reference):
        if "latents" in mine and "latents" in ref:
            latent_rel.append(float((mine["latents"].float() - ref["latents"]).norm() / ref["latents"].norm()))
        image = mine["decoded"]
        if isinstance(image, torch.Tensor):
            image = (image * 255).round().to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()
        pixels = torch.from_numpy(np.array(image)).to(device).float().permute(2, 0, 1)[None] / 255
        decode_rms = max(decode_rms, float(((pixels - ref["decoded"]) ** 2).mean().sqrt()))
    out = {"decode_rms": decode_rms}
    if latent_rel:
        out["latent_rel"] = sum(latent_rel) / len(latent_rel)
    return out
