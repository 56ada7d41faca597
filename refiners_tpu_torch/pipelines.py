"""Text-to-image pipeline; counterpart of ``refiners_tpu/pipelines.py``.

Bundles prompt encoding, the denoising loop and the VAE decode under
``torch.inference_mode()``. As the JAX package jits the loop (its
``lax.scan``) and the decode, the loop and the decode are two compiled
programs (`fluxion.graphs.Program`: CUDA graphs on the card, cached per
key, eager on the CPU), which share one memory pool (they never run at
the same time); the model and its settings make the key, prompts and
seeds are inputs. Pass a ("data", "tensor") mesh (`parallel.make_mesh`)
to run data-parallel over the CFG batch and the images, with
tensor-parallel attention and feed-forward weights when ``tensor > 1``:
every rank of the mesh runs the same call, one process per card
(`torchrun`). A mesh on gloo runs the two programs eagerly (its
collectives run on the host); on NCCL they are captured.

Spans (`fluxion.tracing`): ``refiners.TextToImage.call`` around a call,
``.encode`` (the tokenizers and text encoders), ``refiners.wait.read_images``
(the images read to the host, which waits there for the card) and
``.to_images`` (the PIL images built on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from PIL import Image

from refiners_tpu_torch.fluxion import rng
from refiners_tpu_torch.fluxion.graphs import Pool, Program
from refiners_tpu_torch.fluxion.tracing import span
from refiners_tpu_torch.fluxion.utils import tensor_to_images
from refiners_tpu_torch.foundationals.latent_diffusion.model import LatentDiffusionModel
from refiners_tpu_torch.foundationals.latent_diffusion.stable_diffusion_xl.model import StableDiffusion_XL


@dataclass
class TextToImage:
    """Text-to-image for SD1.5 / SDXL on the model's device.

    Example:
        pipe = TextToImage(sd15)
        image = pipe("a cute cat", negative_prompt="low quality", seed=42)

    `num_images` latents are denoised as one batch (CFG batch 2 × `num_images`).

    Multi-card: `TextToImage(sdxl, mesh=make_mesh(tensor=1), num_images=8)`
    places the model on the mesh at the first call (`shard_latent_diffusion`:
    attention and feed-forward weights split over "tensor" if ``tensor > 1``)
    and splits each step's CFG batch of 16 over "data"; each rank decodes
    its block of the images, and every rank returns all of them.
    """

    sd: LatentDiffusionModel
    size: tuple[int, int] = (512, 512)
    condition_scale: float | None = None
    mesh: Any = None  # a ("data", "tensor") DeviceMesh
    num_images: int = 1
    _compiled: dict[str, Program] = field(default_factory=dict, repr=False)
    _pool: Pool = field(default_factory=Pool, repr=False)
    _generators: dict[torch.device, torch.Generator] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        self._sharded = False
        if self.mesh is not None:
            n_data = self.mesh.size(self.mesh.mesh_dim_names.index("data"))
            assert self.num_images % n_data == 0 or self.num_images == 1, (
                f"num_images={self.num_images} must divide the data axis ({n_data})"
            )

    def _ensure_sharded(self) -> None:
        if self.mesh is None or self._sharded:
            return
        from refiners_tpu_torch.parallel import shard_latent_diffusion

        shard_latent_diffusion(self.sd, self.mesh)
        self._sharded = True

    def _seed(self, seed: int | None, device: torch.device) -> torch.Generator:
        """The pipeline's generator of `device` (the one its programs draw
        from) seeded by `seed`; without one, by a seed drawn from the
        device's seeded generator (on a mesh: rank 0's, given to every rank,
        so that all ranks draw the same noise)."""
        if seed is None:
            drawn = torch.randint(2**62, (1,), generator=rng.generator(device), device=device)
            if self.mesh is not None:
                from refiners_tpu_torch.parallel.sharding import broadcast_from_first

                broadcast_from_first([drawn], self.mesh)
            seed = int(drawn)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device)
        return self._generators[device].manual_seed(seed)

    def _program(self, name: str, fn: Callable[..., Any]) -> Program:
        """`fn` as this pipeline's compiled program `name` (eager on a gloo mesh)."""
        if name not in self._compiled:
            self._compiled[name] = Program(fn, name=f"TextToImage.{name}", mesh=self.mesh, pool=self._pool)
        return self._compiled[name]

    def _decode(self, lda: Any, z: torch.Tensor) -> torch.Tensor:
        """The VAE decode, the second program; on a mesh each rank decodes
        its block of the images and the blocks are gathered, where "data"
        divides them."""
        if self.mesh is None:
            return lda.decode(z)
        from refiners_tpu_torch.parallel import batch_sharding

        sharding = batch_sharding(self.mesh, z.ndim)
        if not sharding.divides(z):
            return lda.decode(z)
        return sharding.gather(lda.decode(sharding.shard(z)))

    @torch.inference_mode()
    def __call__(
        self,
        prompt: str,
        negative_prompt: str = "",
        seed: int | None = None,
        condition_scale: float | None = None,
    ) -> Image.Image | list[Image.Image]:
        """Generate `num_images` images (a single Image when 1). The noise,
        and a stochastic solver's draws, come from the pipeline's generator
        on the model's device seeded by `seed` (else by a seed drawn from the
        device's seeded generator). On a mesh every rank draws the whole
        batch's noise from the same seed, so the images do not depend on the
        mesh."""
        with span("refiners.TextToImage.call"):
            self._ensure_sharded()
            sd = self.sd
            device, dtype = sd.unet.device, sd.unet.dtype
            generator = self._seed(seed, device)
            n = self.num_images
            h, w = self.size
            noise = torch.randn((n, 4, h // 8, w // 8), generator=generator, device=device, dtype=torch.float32)
            x = sd.solver.scale_model_input(noise.to(dtype), step=-1)

            # (2, ...) [uncond, cond] → (2n, ...) [uncond×n, cond×n]: the layout of
            # predict_noise's cat((x, x)) CFG batch
            kwargs: dict[str, Any] = {}
            with span("refiners.TextToImage.encode"):
                if isinstance(sd, StableDiffusion_XL):
                    scale = condition_scale or self.condition_scale or 5.0
                    emb, pooled = sd.compute_clip_text_embedding(prompt, negative_prompt)
                    kwargs = {
                        "pooled_text_embedding": pooled.repeat_interleave(n, dim=0),
                        "time_ids": sd.default_time_ids.repeat_interleave(n, dim=0),
                    }
                else:
                    scale = condition_scale or self.condition_scale or 7.5
                    emb = sd.compute_clip_text_embedding(prompt, negative_prompt)
            z = self._program("diffuse", _diffuse)(sd, x, emb.repeat_interleave(n, dim=0), scale, generator, **kwargs)
            decoded = (self._program("decode", self._decode)(sd.lda, z) + 1) / 2
            with span("refiners.wait.read_images"):  # the host waits here for the loop and the decode
                decoded = decoded.cpu()
            with span("refiners.TextToImage.to_images"):
                images = tensor_to_images(decoded)
        return images[0] if n == 1 else images


def _diffuse(
    sd: LatentDiffusionModel,
    x: torch.Tensor,
    clip_text_embedding: torch.Tensor,
    condition_scale: float,
    generator: torch.Generator,
    **kwargs: torch.Tensor,
) -> torch.Tensor:
    """The denoising loop: `TextToImage`'s first program."""
    return sd.diffuse(
        x, clip_text_embedding=clip_text_embedding, condition_scale=condition_scale, generator=generator, **kwargs
    )
