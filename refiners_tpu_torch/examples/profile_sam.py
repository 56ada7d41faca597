"""Profile the port's SAM-H serving path on one NVIDIA card.

    python -m refiners_tpu_torch.examples.profile_sam

Full-width `SegmentAnythingH` in bf16 with seeded synthetic weights, a
single-mask decoder, one 1024 × 768 image and a prompt of two foreground
points and one background point. Printed:

1. seconds per image embedding, warm, through the relative-position kernel
   and on the plain path (`RelativePositionAttention.is_optimized = False`,
   which materializes the float32 bias), each the median of 5;
2. one embedding through the kernel under ``torch.profiler``: device time by
   kernel kind, the costliest kernels by name, and the idle share of the
   traced window;
3. milliseconds per ``predict`` on that embedding, warm, the median of 10,
   then one under ``torch.profiler``;
4. peak memory, and the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Any, Callable

import numpy as np
import torch
from PIL import Image

from refiners_tpu_torch.examples.profile_train import device_breakdown

IMAGE_SIZE = (1024, 768)  # (width, height)
PROMPT = dict(foreground_points=[(300.0, 300.0), (600.0, 400.0)], background_points=[(100.0, 80.0)])


def _seconds(fn: Callable[[], Any], reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return times


def _profiled(fn: Callable[[], Any]) -> torch.profiler.profile:
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_sam: no CUDA device; this script runs only on an NVIDIA card")
    from refiners_tpu_torch.fluxion.utils import synthesize_weights
    from refiners_tpu_torch.foundationals.segment_anything import SegmentAnythingH
    from refiners_tpu_torch.foundationals.segment_anything.image_encoder import RelativePositionAttention
    from refiners_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    sam = SegmentAnythingH(multimask_output=False, device=dev, dtype=torch.bfloat16)
    synthesize_weights(sam, seed=13)
    sam.eval()
    layers = list(sam.layers(RelativePositionAttention, recurse=True))
    w, h = IMAGE_SIZE
    image = Image.fromarray(np.random.RandomState(0).randint(0, 255, (h, w, 3), dtype=np.uint8))

    with torch.inference_mode():
        for kernel in (True, False):
            for layer in layers:
                layer.is_optimized = kernel
            torch.cuda.reset_peak_memory_stats(dev)
            sam.compute_image_embedding(image)  # warm-up
            times = _seconds(lambda: sam.compute_image_embedding(image), reps=5)
            route = "relative-position kernel" if kernel else "plain path"
            print(
                f"embedding through the {route}: median {statistics.median(times):.4f} s of "
                f"{[round(t, 4) for t in times]}, peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            )

        for layer in layers:
            layer.is_optimized = True
        launches = fa.flash_attention_relpos.launches
        wall = statistics.median(_seconds(lambda: sam.compute_image_embedding(image), reps=3))
        device_breakdown(
            _profiled(lambda: sam.compute_image_embedding(image)), wall, label="one embedding", unit="embedding", top=15
        )
        print(f"relative-position kernel launches over 4 embeddings: {fa.flash_attention_relpos.launches - launches}")

        embedding = sam.compute_image_embedding(image)
        sam.predict(embedding, **PROMPT)  # warm-up
        times = _seconds(lambda: sam.predict(embedding, **PROMPT), reps=10)
        print(f"predict: median {statistics.median(times) * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]}")
        device_breakdown(
            _profiled(lambda: sam.predict(embedding, **PROMPT)),
            statistics.median(times),
            label="one predict",
            unit="predict",
            top=8,
        )
    print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
