"""Profile SDXL 1024² serving under the opt-in passes on one NVIDIA card.

    python -m refiners_tpu_torch.examples.profile_passes

Full-width `StableDiffusion_XL` in bf16 with seeded synthetic weights. For
each configuration in turn, on the same model,

1. unfused: the plain GroupNorm and SiLU layers, bf16 linears;
2. fused: ``fuse_group_norm_silu`` on the UNet and the VAE (K5a, K5b);
3. fused + int8: then ``quantize_linears(unet, min_features=256)``, W8A8;

printed: the host-clock milliseconds of one UNet step (CFG batch 2, the
median of 3, warm) and of one VAE decode of a 128 × 128 latent, then each
under ``torch.profiler``: device time by kernel kind, the costliest kernels
by name, and the idle share of the traced window; peak memory; the card's
name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Any, Callable

import torch

from refiners_tpu_torch.examples.profile_sam import _profiled
from refiners_tpu_torch.examples.profile_train import device_breakdown


def _median_ms(fn: Callable[[], Any], reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_passes: no CUDA device; this script runs only on an NVIDIA card")
    from refiners_tpu_torch.fluxion import manual_seed
    from refiners_tpu_torch.fluxion.optimization import fuse_group_norm_silu, quantize_linears
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.latent_diffusion import DDIM, StableDiffusion_XL

    dev = torch.device("cuda", 0)
    manual_seed(0)
    sd = StableDiffusion_XL(solver=DDIM(num_inference_steps=30, device=dev), device=dev, dtype=torch.bfloat16)
    synthesize_weights(sd, seed=7)
    gen = torch.Generator(dev).manual_seed(0)
    with torch.inference_mode():
        emb, pooled = sd.compute_clip_text_embedding("a cute cat sitting on a windowsill", "blurry")
        x = torch.randn((1, 4, 128, 128), generator=gen, device=dev, dtype=torch.bfloat16)

    def step() -> torch.Tensor:
        return sd.predict_noise(
            x, 0, clip_text_embedding=emb, pooled_text_embedding=pooled, time_ids=sd.default_time_ids, condition_scale=5.0
        )

    def decode() -> torch.Tensor:
        return sd.lda.decode(x)

    def prepare(name: str) -> None:
        if name == "fused":
            print(f"fuse_group_norm_silu: {fuse_group_norm_silu(sd.unet)} UNet and {fuse_group_norm_silu(sd.lda)} VAE pairs")
        elif name == "fused + int8":
            print(f"quantize_linears: {quantize_linears(sd.unet, min_features=256)} UNet linears")

    for name in ("unfused", "fused", "fused + int8"):
        prepare(name)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats(dev)
            step()  # warm-up
            step_ms = _median_ms(step)
            print(f"[{name}] one UNet step (1024², CFG batch 2): median {step_ms:.1f} ms")
            device_breakdown(_profiled(step), step_ms / 1e3, label=f"[{name}] one UNet step", unit="step", top=8)
            if name != "fused + int8":  # quantize_linears changes only the UNet
                decode()
                decode_ms = _median_ms(decode)
                print(f"[{name}] one VAE decode (1024²): median {decode_ms:.1f} ms")
                device_breakdown(_profiled(decode), decode_ms / 1e3, label=f"[{name}] one VAE decode", unit="decode", top=5)
            print(f"[{name}] peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
